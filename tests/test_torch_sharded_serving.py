"""LM serving under a sharding policy, four ``gloo`` ranks on the CPU,
against the JAX package's unsharded engine.

One subprocess (``tests/_torch_sharded_ranks.py``, which imports only
``repro_torch``) runs four ranks of one process group and serves five
cases through ``ServeEngine(policy=ShardingPolicy(mesh, cfg, profile))``
on backend ``cuda`` (the kernel wrappers' plain versions on CPU tensors),
with the parameters distributed by the policy's shardings:
RecurrentGemma, Qwen3-MoE and DeepSeek-V2 smoke under ``tp`` on a
(data 2, model 2) mesh; SmolLM smoke under ``tp_seq`` on (1, 4), its
prompts of lengths divisible by 4 (so the residual stream is
sequence-sharded), and under ``fsdp`` on (4, 1).  RecurrentGemma's
prompts run past the smoke window of 16.  The same seeded numpy
parameters go through ``repro.serving.engine.ServeEngine`` unsharded:
token lists must be identical and the prefill logits within 1e-4 of their
scale.  Every parameter must be a DTensor whose placements are its spec's,
and those specs must be the reference policy's on a mesh of the same
shape.  The reference runs while the ranks do.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import configs as JC
from repro.launch import sharding as jsh
from repro.models import model as jmodel
from repro.serving import engine as jengine

from _torch_params import numpy_lm_params

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TOL = 1e-4
RANKS_TIMEOUT_S = 240
MAX_NEW = 3
MAX_SEQ = 32

# name: (arch, profile, (data, model), prompt lengths); the longer prompts
# are teacher-forced through the first decode steps
CASES = {
    "rg_tp": ("recurrentgemma_2b", "tp", (2, 2), (17, 18, 18, 19)),
    "qwen_tp": ("qwen3_moe_235b", "tp", (2, 2), (5, 6, 6, 7)),
    "deepseek_tp": ("deepseek_v2_236b", "tp", (2, 2), (5, 6, 6, 7)),
    "smol_tp_seq": ("smollm_135m", "tp_seq", (1, 4), (8, 8, 8, 12)),
    "smol_fsdp": ("smollm_135m", "fsdp", (4, 1), (5, 6, 6, 7)),
}


def _prompts(name, vocab):
    rng = np.random.default_rng(sorted(CASES).index(name))
    return [rng.integers(0, vocab, n).tolist() for n in CASES[name][3]]


def _reference(name, np_params):
    """The reference's unsharded generate: token lists and the prefill's
    logits."""
    arch = CASES[name][0]
    jm = jmodel.LanguageModel(JC.get_smoke_config(arch))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    eng = jengine.ServeEngine(jm, jp, max_seq=MAX_SEQ, batch_slots=4)
    prefill, kept = eng._prefill, []

    def keep(*args):
        logits, cache = prefill(*args)
        kept.append(np.asarray(logits))
        return logits, cache

    eng._prefill = keep
    reqs = [jengine.Request(p, MAX_NEW)
            for p in _prompts(name, jm.cfg.vocab_size)]
    return eng.generate(reqs), kept[0]


def _reference_specs(name, np_params):
    arch, profile, shape, _ = CASES[name]
    policy = jsh.ShardingPolicy(AbstractMesh(shape, ("data", "model")),
                                JC.get_smoke_config(arch), profile)
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for s in jax.tree_util.tree_leaves(
                policy.param_specs(np_params),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Start the four ranks, compute the references meanwhile, then read
    what rank 0 wrote."""
    tmp = tmp_path_factory.mktemp("sharded")
    params, cases = {}, []
    for name, (arch, profile, shape, _) in CASES.items():
        if arch not in params:
            params[arch] = numpy_lm_params(JC.get_smoke_config(arch))
            np.savez(tmp / f"{arch}.npz", *[
                np.asarray(a) for a in jax.tree_util.tree_leaves(
                    params[arch])])
        cases.append(dict(name=name, arch=arch, profile=profile,
                          mesh=list(shape), params=str(tmp / f"{arch}.npz"),
                          prompts=_prompts(
                              name, JC.get_smoke_config(arch).vocab_size),
                          max_new=MAX_NEW, max_seq=MAX_SEQ))
    (tmp / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=SRC)
    log = tmp / "ranks.log"
    with open(log, "w") as out:       # a file: no pipe for the ranks to fill
        proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_sharded_ranks.py"),
             str(tmp / "cases.json"), str(tmp)], env=env, stdout=out,
            stderr=subprocess.STDOUT)
        try:
            refs = {name: (*_reference(name, params[CASES[name][0]]),
                           _reference_specs(name, params[CASES[name][0]]))
                    for name in CASES}
            proc.wait(timeout=RANKS_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, log.read_text()[-6000:]
    got = {}
    for name in CASES:
        with open(tmp / f"{name}.json") as f:
            got[name] = json.load(f)
        got[name]["prefill"] = np.load(tmp / f"{name}.npy")
    return got, refs


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_tokens_equal_the_unsharded_reference(served, name):
    got, refs = served
    assert got[name]["tokens"] == refs[name][0]
    assert [len(t) for t in got[name]["tokens"]] == [MAX_NEW] * 4


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_prefill_logits_match_the_reference(served, name):
    got, refs = served
    ref = refs[name][1]
    assert got[name]["prefill_calls"] == 1
    assert got[name]["prefill"].shape == ref.shape
    np.testing.assert_allclose(
        got[name]["prefill"], ref, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_parameter_is_placed_by_the_reference_policy(served, name):
    """Each leaf is a DTensor with its spec's placements, the specs are
    the reference policy's, and the policy shards some leaves on "model"
    wherever the mesh has a model axis wider than 1."""
    got, refs = served
    assert got[name]["placed"] and all(got[name]["placed"])
    assert got[name]["specs"] == refs[name][2]
    wide_model = CASES[name][2][1] > 1
    assert (got[name]["model_sharded"] > 0) == wide_model
