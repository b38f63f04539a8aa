"""Hybrid-network search (paper §4.2): evolutionary search + manual baseline.

Genome: a bitmask over the network's spatial stages (True = FuSe-Half,
False = depthwise).  Fitness combines a task-accuracy evaluator with
latency from the systolic simulator (the paper's EA: population 100,
mutation 0.1, parent ratio 0.25, 100 iterations).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.systolic.arrays import SystolicConfig, PAPER_CONFIG
from repro_torch.systolic.simulator import simulate_network
from repro_torch.vision import zoo


def mask_to_variants(mask: Sequence[bool]) -> List[str]:
    return ["fuse_half" if m else "depthwise" for m in mask]


def latency_ms(net: zoo.NetworkDef, mask: Sequence[bool],
               cfg: SystolicConfig = PAPER_CONFIG) -> float:
    sim = simulate_network(zoo.lower_to_ir(net, mask_to_variants(mask)), cfg)
    return sim.latency_ms


# ---------------------------------------------------------------------------
# Manual baseline (paper §6.2 "50%" variants): replace the half of the
# stages with the largest latency impact, chosen greedily.
# ---------------------------------------------------------------------------

def greedy_latency_mask(net: zoo.NetworkDef, fraction: float = 0.5,
                        cfg: SystolicConfig = PAPER_CONFIG) -> List[bool]:
    n = net.num_spatial_stages
    base = latency_ms(net, [False] * n, cfg)
    gains = []
    for i in range(n):
        mask = [False] * n
        mask[i] = True
        gains.append(base - latency_ms(net, mask, cfg))
    order = np.argsort(gains)[::-1]
    k = int(round(fraction * n))
    mask = [False] * n
    for i in order[:k]:
        mask[i] = True
    return mask


# ---------------------------------------------------------------------------
# Evolutionary search (adapting Real et al. 2017, as the paper does).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EAConfig:
    population: int = 100
    iterations: int = 100
    mutation_prob: float = 0.1
    parent_ratio: float = 0.25
    latency_weight: float = 0.0      # scalarized fitness: acc - w * latency_ms
    latency_budget_ms: Optional[float] = None  # or: hard budget constraint
    seed: int = 0


def evolutionary_search(
        net: zoo.NetworkDef,
        accuracy_fn: Callable[[Sequence[bool]], float],
        cfg: EAConfig = EAConfig(),
        hw: SystolicConfig = PAPER_CONFIG) -> Dict:
    """Maximize accuracy/latency fitness over hybrid masks.

    ``accuracy_fn(mask) -> float`` is supplied by the caller: at container
    scale it evaluates a NOS-trained scaffold collapsed under ``mask`` on
    held-out data (the paper evaluates sampled subnets of the scaffold the
    same way); unit tests use synthetic fitness surfaces.
    Returns dict with the best mask and the full evaluation history (for
    Pareto plots).
    """
    rng = np.random.default_rng(cfg.seed)
    n = net.num_spatial_stages
    lat_cache: Dict[Tuple[bool, ...], float] = {}
    acc_cache: Dict[Tuple[bool, ...], float] = {}

    def lat(mask) -> float:
        key = tuple(mask)
        if key not in lat_cache:
            lat_cache[key] = latency_ms(net, mask, hw)
        return lat_cache[key]

    def acc(mask) -> float:
        key = tuple(mask)
        if key not in acc_cache:
            acc_cache[key] = float(accuracy_fn(list(mask)))
        return acc_cache[key]

    def fitness(mask) -> float:
        a, l = acc(mask), lat(mask)
        if cfg.latency_budget_ms is not None and l > cfg.latency_budget_ms:
            return a - 1e3 * (l - cfg.latency_budget_ms)
        return a - cfg.latency_weight * l

    pop = [tuple(rng.random(n) < 0.5) for _ in range(cfg.population)]
    history = []
    for it in range(cfg.iterations):
        scored = sorted(pop, key=fitness, reverse=True)
        n_parents = max(2, int(cfg.parent_ratio * cfg.population))
        parents = scored[:n_parents]
        history.append({"iter": it, "best_mask": list(scored[0]),
                        "best_fitness": fitness(scored[0]),
                        "best_acc": acc(scored[0]),
                        "best_latency_ms": lat(scored[0])})
        children = []
        while len(children) < cfg.population - n_parents:
            if rng.random() < 0.5:          # crossover
                a, b = (parents[rng.integers(len(parents))] for _ in range(2))
                cut = rng.integers(1, n) if n > 1 else 0
                child = a[:cut] + b[cut:]
            else:                            # mutation
                a = parents[rng.integers(len(parents))]
                child = tuple(
                    (not g) if rng.random() < cfg.mutation_prob else g
                    for g in a)
            children.append(child)
        pop = list(parents) + children

    best = max(pop, key=fitness)
    evaluated = [{"mask": list(m), "acc": acc_cache[m], "latency_ms": lat_cache[m]}
                 for m in acc_cache]
    return {"best_mask": list(best), "best_acc": acc(best),
            "best_latency_ms": lat(best), "history": history,
            "evaluated": evaluated}


def pareto_front(points: List[Dict]) -> List[Dict]:
    """Non-dominated (max acc, min latency) subset, sorted by latency."""
    pts = sorted(points, key=lambda p: (p["latency_ms"], -p["acc"]))
    front, best_acc = [], -1.0
    for p in pts:
        if p["acc"] > best_acc:
            front.append(p)
            best_acc = p["acc"]
    return front
