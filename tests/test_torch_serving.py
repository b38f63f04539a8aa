"""The port's serving stack on the CPU, against the JAX package.

* The registry and the synchronous engine (``device="cpu"``,
  ``pipelined=False``, whose batch composition the counts below pin)
  answer mixed requests to ``tiny_net/fuse_half`` and
  ``tiny_net/depthwise``; each
  result equals the JAX reference logits of ``fit_image(img)[None]``
  (rtol=atol=1e-4) and batching does not change results.
* SLO admission rejects exactly as the cost model predicts.
* ``ModelRegistry()`` asks for CUDA and raises without a card; the engine
  refuses multi-process serving on the sync engine and a cost model sized
  for another mesh.
* The port and ``chip_smoke.py`` import neither ``jax`` nor ``repro``
  (every module, ``launch/`` included).
"""
import ast
import pathlib

import numpy as np
import pytest
import torch
from _torch_params import jax_logits, numpy_params

from repro.serving.vision import batcher as jbatcher
from repro.serving.vision import costmodel as jcostmodel
from repro.serving.vision import registry as jregistry
from repro.vision import zoo as jzoo
from repro_torch.serving.vision import (ModelRegistry, SystolicCostModel,
                                        VisionServeEngine, fit_image)
from repro_torch.vision import zoo as tzoo
from repro_torch.vision.convert import params_from_numpy

RTOL = ATOL = 1e-4
ROOT = pathlib.Path(__file__).resolve().parents[1]
JNET = jzoo.tiny_net()          # resolution 32, 10 classes
TNET = tzoo.tiny_net()
VARIANTS = ("fuse_half", "depthwise")
PARAMS = {v: numpy_params(JNET, v, seed=i) for i, v in enumerate(VARIANTS)}


def _engine(backend="cuda", buckets=(1, 2, 4)):
    reg = ModelRegistry(backend=backend, device="cpu")
    for v in VARIANTS:
        reg.register(TNET, v, params=params_from_numpy(PARAMS[v], "cpu"))
    return VisionServeEngine(reg, cost_model=SystolicCostModel(),
                             buckets=buckets, pipelined=False)


def _images(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(16, 64)),
                                 int(rng.integers(16, 64)), 3)
                                ).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_engine_matches_jax_reference(backend):
    engine = _engine(backend)
    keys = [f"tiny_net/{v}" for v in VARIANTS]
    submitted = [(engine.submit(keys[i % 2], img), keys[i % 2], img)
                 for i, img in enumerate(_images(9))]
    results = engine.flush()
    assert [r.rid for r in results] == [rid for rid, _, _ in submitted]
    for (rid, key, img), r in zip(submitted, results):
        assert r.status == "ok" and r.logits.shape == (10,)
        np.testing.assert_array_equal(fit_image(img, 32),
                                      jbatcher.fit_image(img, 32))
        variant = key.split("/")[1]
        ref = jax_logits(PARAMS[variant], JNET,
                         jbatcher.fit_image(img, 32)[None], variant)
        np.testing.assert_allclose(r.logits, ref[0], rtol=RTOL, atol=ATOL)
        assert r.predicted_ms > 0 and r.run_ms > 0 and r.e2e_ms >= r.run_ms
    snap = engine.snapshot()
    assert snap["completed"] == 9 and snap["batches"] == 3   # 4+1, 4


def test_batching_does_not_change_results():
    img = _images(1, seed=2)[0]
    key = "tiny_net/fuse_half"
    batched = _engine(buckets=(4,))
    rid = batched.submit(key, img)
    for other in _images(3, seed=3):
        batched.submit(key, other)
    got = {r.rid: r for r in batched.flush()}[rid]
    solo = _engine(buckets=(1,))
    rid2 = solo.submit(key, img)
    want = {r.rid: r for r in solo.flush()}[rid2]
    assert got.bucket == 4 and want.bucket == 1
    np.testing.assert_allclose(got.logits, want.logits, rtol=1e-5, atol=1e-5)


def test_admission_rejects_as_the_cost_model_predicts():
    engine = _engine(buckets=(1,))
    cm = engine.cost_model
    fuse = engine.registry.get("tiny_net/fuse_half")
    img = np.zeros((32, 32, 3), np.float32)
    # the copied cost model prices the port's IR exactly as the reference
    jreg = jregistry.ModelRegistry(backend="xla")
    jmodel = jreg.register(JNET, "fuse_half", params=[])
    assert cm.predicted_ms(fuse, 1) == \
        jcostmodel.SystolicCostModel().predicted_ms(jmodel, 1)
    slo = cm.predicted_ms(fuse, 1) * 2      # fits alone, not behind 4 more
    for _ in range(4):
        engine.submit("tiny_net/depthwise", img)
    ok, predicted = cm.admit(fuse, slo, 0, engine.buckets,
                             engine._backlog_ms("tiny_net/fuse_half"))
    rid = engine.submit("tiny_net/fuse_half", img, slo_ms=slo)
    res = engine.future(rid).result(0)
    assert not ok and res.status == "rejected" and res.logits is None
    assert res.predicted_ms == predicted > slo
    results = {r.rid: r for r in engine.flush()}
    assert results[rid].status == "rejected"
    assert sum(r.status == "ok" for r in results.values()) == 4
    rid2 = engine.submit("tiny_net/fuse_half", img, slo_ms=slo)
    assert engine.poll(rid2).status == "ok"          # empty queue: admitted
    m = engine.snapshot()
    assert m["rejected"] == 1 and m["submitted"] == 6


def test_engine_refuses_unported_modes_and_closes():
    """What the engine still refuses, as the reference's does: multiprocess
    serving on the sync engine, and a cost model planning for another
    device count than the registry's mesh has."""
    from repro_torch.launch.mesh import make_data_mesh
    with pytest.raises(ValueError, match="multiprocess"):
        VisionServeEngine(ModelRegistry(device="cpu"),
                          multiprocess=object(), pipelined=False)
    mesh = make_data_mesh(2, device="cpu",
                          env={"REPRO_TORCH_VIRTUAL_DEVICES": "2"})
    with pytest.raises(ValueError, match="mesh has 2"):
        VisionServeEngine(ModelRegistry(mesh=mesh),
                          cost_model=SystolicCostModel())
    engine = _engine()
    rid = engine.submit("tiny_net/depthwise", np.zeros((8, 8, 3), np.float32))
    engine.close(drain=False)
    assert engine.future(rid).result(0).status == "cancelled"
    with pytest.raises(RuntimeError):
        engine.submit("tiny_net/depthwise", np.zeros((8, 8, 3), np.float32))


def test_registry_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRegistry()
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelRegistry(backend="torch", device="cuda")
    reg = ModelRegistry(device="cpu")
    reg.register(TNET, "fuse_half", params=[], key="k")
    with pytest.raises(ValueError):
        reg.register(TNET, "fuse_half", params=[], key="k")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "scripts" / "multiprocess_check_torch.py")
    files.append(ROOT / "examples" / "nos_distillation_torch.py")
    assert len(files) > 20
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"src/repro_torch/serving/vision/interface.py",
            "src/repro_torch/serving/vision/traffic.py",
            "src/repro_torch/launch/__init__.py",
            "src/repro_torch/launch/serve_vision.py",
            "src/repro_torch/serving/vision/compilecache.py",
            "src/repro_torch/vision/counting.py",
            "src/repro_torch/core/nos.py",
            "src/repro_torch/core/ofa.py",
            "src/repro_torch/core/search.py",
            "src/repro_torch/train/vision.py",
            "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/schedules.py",
            "src/repro_torch/data/vision_synth.py",
            "src/repro_torch/data/prefetch.py",
            "src/repro_torch/models/model.py",
            "src/repro_torch/models/convert.py",
            "src/repro_torch/configs/recurrentgemma_2b.py",
            "src/repro_torch/serving/engine.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/distributed.py",
            "src/repro_torch/launch/env.py",
            "src/repro_torch/serving/vision/multiproc.py",
            "scripts/multiprocess_check_torch.py",
            "examples/nos_distillation_torch.py"} <= names
    bad = [(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
