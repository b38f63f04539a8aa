"""The port's launcher (``repro_torch.launch.serve_vision``) on the CPU.

* Against the JAX launcher (``repro.launch.serve_vision``, backend
  ``xla``) on the same command: ``tiny_net/depthwise tiny_net/fuse_full``,
  8 requests, the sync engine and ``--min-calibration-samples 1000``, which
  keeps every plan on the uncalibrated systolic cost model so that neither
  framework's wall times can move it.  Per request: the same status,
  bucket and predicted ms; the snapshots have the same keys, less the
  jit-entry count and the multi-process keys, whose meaning does not
  carry over (``NOT_CARRIED``).  Logits are not compared: each launcher draws its own
  seeded weights (weight-carried logit parity is in test_torch_engine.py).
* ``--tenant`` and ``--shed`` run on the pipelined engine.
* Each flag of what is not ported exits with a one-line message naming
  its ROADMAP item.
* ``make_tenant_trace`` gives the JAX package's trace for the same specs
  and seed.
"""
import json
import re

import numpy as np
import pytest

import repro.launch.serve_vision as jlaunch
import repro.serving.vision as jsv
import repro_torch.launch.serve_vision as tlaunch
import repro_torch.serving.vision as tsv
from repro.vision import zoo as jzoo
from repro_torch.vision import zoo as tzoo

COMMON = ["--models", "tiny_net/depthwise", "tiny_net/fuse_full",
          "--requests", "8", "--resolution", "16", "--buckets", "1", "2",
          "4", "--engine", "sync", "--min-calibration-samples", "1000"]
# snapshot keys of the reference with no meaning in the port: jit entries
# and multi-process counters
NOT_CARRIED = {"multiprocess", "compilation.jit_entries"}
REQ = re.compile(r"^req +(\d+) (\S+) +(\S+) +top1= *-?\d+ bucket=(\d+) "
                 r"predicted= *([\d.]+)(acc-ms|cal-ms)")


def _run(main, argv, capsys):
    main(argv)
    out = capsys.readouterr().out
    rows = [m.groups() for m in map(REQ.match, out.splitlines()) if m]
    return rows, out


def _keys(snap):
    keys = set(snap)
    keys |= {f"compilation.{k}" for k in snap["compilation"]}
    keys |= {f"compile_log.{k}" for e in snap["compilation"]["compile_log"]
             for k in e}
    return keys


def test_launcher_matches_the_jax_launcher(tmp_path, capsys):
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    want, _ = _run(jlaunch.main, COMMON + ["--backend", "xla",
                                           "--json", str(jpath)], capsys)
    got, _ = _run(tlaunch.main, COMMON + ["--device", "cpu",
                                          "--json", str(tpath)], capsys)
    assert len(want) == 8 and got == want
    assert {status for _, _, status, *_ in got} == {"ok"}
    jsnap, tsnap = (json.loads(p.read_text()) for p in (jpath, tpath))
    assert _keys(tsnap) == _keys(jsnap) - NOT_CARRIED
    for key in ("mode", "mesh_devices", "num_processes", "replan",
                "completed", "batches", "shed_enabled", "round_planner"):
        assert tsnap[key] == jsnap[key], key
    assert tsnap["compilation"]["entries_built"] == 6     # 2 models x 3


def test_tenants_and_shedding_run(tmp_path, capsys):
    path = tmp_path / "tenants.json"
    rows, out = _run(tlaunch.main, [
        "--models", "tiny_net/depthwise", "tiny_net/fuse_full",
        "--resolution", "16", "--buckets", "1", "2", "4", "--device", "cpu",
        "--requests", "6", "--shed",
        "--tenant", "search:poisson:150:interactive:40",
        "--tenant", "ads:bursty:50:batch", "--json", str(path)], capsys)
    snap = json.loads(path.read_text())
    assert len(rows) == 12 and snap["mode"] == "pipelined"
    assert {status for _, _, status, *_ in rows} <= {"ok", "rejected",
                                                     "shed"}
    assert snap["shed_enabled"] and set(snap["tenants"]) == {"search", "ads"}
    assert re.search(r"^shed=\{.*\} fairness=", out, re.M)


@pytest.mark.parametrize("flag,value,item", [
    ("--mesh", "2", "4.2"),
    ("--coordinator", "localhost:1234", "7"),
    ("--num-processes", "2", "7"),
    ("--process-id", "1", "7"),
])
def test_unported_flags_exit_with_their_roadmap_item(flag, value, item):
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", flag, value])
    message = str(exc.value)
    assert "not ported" in message and message.endswith(f"item {item}")
    assert "\n" not in message


def test_tenant_trace_matches_the_jax_package():
    jreg = jsv.ModelRegistry(backend="xla")
    treg = tsv.ModelRegistry(device="cpu")
    for reg, zoo in ((jreg, jzoo), (treg, tzoo)):
        for v in ("depthwise", "fuse_half"):
            reg.register(zoo.tiny_net(resolution=16), v, params=[])
    specs = {}
    for name, sv in (("jax", jsv), ("torch", tsv)):
        specs[name] = [
            sv.TenantSpec("a", rate_rps=120.0, slo_class="interactive",
                          slo_ms=30.0),
            sv.TenantSpec("b", pattern="bursty", burst_len=4),
            sv.TenantSpec("c", pattern="diurnal", period_ms=50.0,
                          weights=(3.0, 1.0)),
            sv.TenantSpec("d", pattern="heavy_tail", alpha=1.2)]
    want = jsv.make_tenant_trace(jreg, specs["jax"], 7, seed=3)
    got = tsv.make_tenant_trace(treg, specs["torch"], 7, seed=3)
    assert len(got) == len(want) == 28
    for (t1, s1, k1, img1), (t2, s2, k2, img2) in zip(got, want):
        assert (t1, s1.name, s1.slo_class, s1.slo_ms, k1) == \
            (t2, s2.name, s2.slo_class, s2.slo_ms, k2)
        assert img1.dtype == img2.dtype and np.array_equal(img1, img2)
