"""Warm restarts of the port: the kernel build cache and the warmup
manifest (the port's analogue of tests/test_serve_restart.py).

* Two fresh launcher processes (``repro_torch.launch.serve_vision``) on
  the CPU share one cache directory and one manifest: the cold run
  writes the manifest (version, fingerprint, entries) and is not
  replayed; the warm run replays it and serves bitwise-identical logits
  (same ``logits_sha256``), every status ``ok``.  The sync engine and an
  unreachable calibration threshold keep the batch composition, and with
  it the summation order, the same in both processes.
* A manifest with another fingerprint, and a corrupt one, are ignored:
  the set is derived, warmed and written anew.
* ``kernels/_build.py`` counts what ``build()`` finds, with a stub
  ``nvcc`` that writes its ``-o`` target: a fresh directory counts one
  miss per source, a second ``build()`` hits only.  (The card's run of
  the real compiler is ``chip_smoke.py`` phase 7.)
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from repro_torch.kernels import _build
from repro_torch.serving.vision import (ModelRegistry, compilecache,
                                        create_engine)
from repro_torch.vision import zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny_net/fuse_full"


def _launch(cache_dir, manifest, json_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(ROOT, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    env.pop(compilecache.ENV_CACHE_DIR, None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_vision",
         "--device", "cpu", "--models", MODEL, "--resolution", "16",
         "--engine", "sync", "--min-calibration-samples", "1000",
         "--requests", "8", "--compilation-cache-dir", str(cache_dir),
         "--warmup-manifest", str(manifest), "--json", str(json_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    statuses = [line.split()[3] for line in proc.stdout.splitlines()
                if line.startswith("req ")]
    compile_line = [line for line in proc.stdout.splitlines()
                    if line.startswith("compile ")]
    with open(json_path) as f:
        return json.load(f), statuses, compile_line


@pytest.fixture(scope="module")
def restart_pair(tmp_path_factory):
    base = tmp_path_factory.mktemp("restart")
    cache, manifest = base / "cache", base / "cache" / "m.json"
    cold = _launch(cache, manifest, base / "cold.json")
    doc = json.loads(manifest.read_text())
    warm = _launch(cache, manifest, base / "warm.json")
    return cold, warm, doc, cache


def test_cold_run_writes_the_manifest(restart_pair):
    (snap, statuses, line), _, doc, cache = restart_pair
    comp = snap["compilation"]
    assert comp["manifest_replayed"] is False
    assert comp["warmup_entries"] == 4                  # buckets 1, 2, 4, 8
    assert comp["cache_dir"] == str(cache.resolve())
    assert comp["persistent"]["misses"] == 0    # CPU: nothing to compile
    assert len(statuses) == 8 and set(statuses) == {"ok"}
    assert len(line) == 1 and "pcache_hits=0 pcache_misses=0" in line[0]
    assert doc["version"] == 1 and doc["fingerprint"]
    assert doc["entries"] == [[MODEL, b, None] for b in (1, 2, 4, 8)]


def test_warm_run_replays_it_bitwise(restart_pair):
    (cold, _, _), (warm, statuses, _), _, _ = restart_pair
    assert warm["compilation"]["manifest_replayed"] is True
    assert warm["compilation"]["warmup_entries"] \
        == cold["compilation"]["warmup_entries"]
    assert warm["compilation"]["warmup_pcache_misses"] == 0
    assert warm["logits_sha256"] == cold["logits_sha256"]
    assert len(statuses) == 8 and set(statuses) == {"ok"}


@pytest.mark.parametrize("bad", ["stale", "corrupt", "no_model"])
def test_bad_manifest_is_ignored_and_rewritten(tmp_path, bad):
    reg = ModelRegistry(device="cpu")
    reg.register(zoo.tiny_net(resolution=16, width=8), "fuse_full")
    manifest = tmp_path / "m.json"
    manifest.write_text({
        "stale": json.dumps({"version": 1, "fingerprint": "other",
                             "entries": [[MODEL, 2, None]]}),
        "corrupt": '{"version": 1, "fingerprint": ',
        "no_model": json.dumps({"version": 1,
                                "fingerprint": reg.backend_fingerprint(),
                                "entries": [["elsewhere/fuse_half", 2,
                                             None]]}),
    }[bad])
    engine = create_engine(reg, "sync", buckets=(1, 2))
    try:
        entries = engine.warmup(manifest_path=str(manifest))
        assert engine.snapshot()["compilation"]["manifest_replayed"] is False
    finally:
        engine.close()
    assert entries == [(MODEL, 1, None), (MODEL, 2, None)]
    doc = json.loads(manifest.read_text())
    assert doc["fingerprint"] == reg.backend_fingerprint()
    assert doc["entries"] == [[MODEL, 1, None], [MODEL, 2, None]]
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]


def test_replay_warms_only_the_manifest_entries(tmp_path):
    """A matching manifest decides the warmed set: here one bucket of
    the two the engine serves."""
    reg = ModelRegistry(device="cpu")
    reg.register(zoo.tiny_net(resolution=16, width=8), "fuse_full")
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({
        "version": 1, "fingerprint": reg.backend_fingerprint(),
        "entries": [[MODEL, 2, None]]}))
    engine = create_engine(reg, "pipelined", buckets=(1, 2))
    try:
        assert engine.warmup(manifest_path=str(manifest)) == [
            (MODEL, 2, None)]
        comp = engine.snapshot()["compilation"]
    finally:
        engine.close()
    assert comp["manifest_replayed"] is True and comp["warmup_entries"] == 1
    assert reg.compiled_buckets() == [(MODEL, 2)]


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A compiler that writes its ``-o`` target and nothing else."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = \"-o\" ]; then shift; "
                    "echo stub > \"$1\"; fi\n"
                    "  shift\n"
                    "done\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_dir", tmp_path / "kernels")
    return tmp_path / "kernels"


def test_build_counts_misses_then_hits(stub_nvcc):
    before = _build.counters()
    infos = _build.build()
    cold = compilecache.counters_delta(before)
    assert set(infos) == set(_build.SOURCES)
    assert all(i.path.parent == stub_nvcc and i.path.exists()
               for i in infos.values())
    n = len(_build.SOURCES)
    assert (cold["requests"], cold["hits"], cold["misses"]) == (n, 0, n)
    assert cold["compile_s"] > 0
    before = _build.counters()
    again = _build.build()
    warm = compilecache.counters_delta(before)
    assert (warm["requests"], warm["hits"], warm["misses"]) == (n, n, 0)
    assert warm["compile_s"] == 0
    assert {k: i.path for k, i in again.items()} \
        == {k: i.path for k, i in infos.items()}


def test_build_dir_moves_only_before_a_library_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_dir", _build.BUILD_DIR)
    monkeypatch.setenv(compilecache.ENV_CACHE_DIR, str(tmp_path / "env"))
    assert compilecache.enable_compilation_cache() == str(tmp_path / "env")
    assert _build.build_dir() == tmp_path / "env" and _build.build_dir().is_dir()
    explicit = tmp_path / "explicit"
    assert compilecache.enable_compilation_cache(str(explicit)) \
        == str(explicit)
    loaded = types.SimpleNamespace(_name=str(explicit / "fused-0.so"))
    monkeypatch.setitem(_build._libs, "fused", loaded)
    assert compilecache.enable_compilation_cache(str(explicit)) \
        == str(explicit)                                  # same: a no-op
    with pytest.raises(RuntimeError, match="cannot move"):
        _build.set_build_dir(tmp_path / "elsewhere")
    assert _build.build_dir() == explicit


def test_registry_without_a_directory_keeps_the_default(monkeypatch):
    monkeypatch.setattr(_build, "_dir", _build.BUILD_DIR)
    monkeypatch.delenv(compilecache.ENV_CACHE_DIR, raising=False)
    reg = ModelRegistry(device="cpu")
    assert reg.compilation_cache_dir is None
    assert _build.build_dir() == _build.BUILD_DIR
    reg.register(zoo.tiny_net(resolution=16, width=8), "fuse_full")
    reg.warm_entry(MODEL, 1)
    stats = reg.compile_stats()
    assert stats["cache_dir"] is None
    assert [(e["pcache_hits"], e["pcache_misses"])
            for e in stats["compile_log"]] == [(0, 0)]
    assert np.isfinite(stats["build_ms_total"])
