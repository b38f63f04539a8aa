"""Fault-tolerant checkpointing: atomic, async.

Port of ``repro.train.checkpoint`` for one device, in the reference's
format: one ``state.npz`` of flattened leaves keyed by their ``/``-joined
paths (dict keys, list indices) and a ``manifest.json`` (step, data
cursor).  Writes go to a temp dir and are renamed atomically (a crash
mid-write never corrupts the latest checkpoint); one save is in flight at
a time, on a background thread, and its error is raised at ``wait()``.
The state is copied to the host before ``save`` returns, so the caller
may update its tensors in place at once.

bfloat16 leaves are stored as their ``int16`` bit pattern (numpy has no
bfloat16 dtype of its own) and listed in the manifest under
``"bfloat16"``; ``restore`` reads them back bit for bit.  It also reads the
reference's npz, whose bfloat16 leaves arrive as 2-byte void (``|V2``)
arrays: the same bits.  ``restore(step, template)`` returns the state with
each leaf in the template leaf's dtype and on its device.  The
reference's elastic re-shard on restore waits for a trainer over a mesh
(ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path

PyTree = Any

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (always a copy: the caller may write ``t`` in
    place while the save thread reads this); bfloat16 as its int16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on ``like``'s device.  A
    bfloat16 leaf stored as 2-byte bits (int16, uint16, or the reference's
    void ``|V2``) is viewed, not converted."""
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and \
            arr.dtype.kind in "iuV":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
    return t.to(like.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the last save that finished: step, bytes, host-copy and write
        # seconds
        self.last_save: Optional[dict] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: PyTree, *, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()                     # one in-flight save at a time
        t0 = time.perf_counter()
        flat, bf16 = {}, []

        def host(path, t):
            k = _key(path)
            if t.dtype == torch.bfloat16:
                bf16.append(k)
            flat[k] = _to_numpy(t)

        tree_map_with_path(host, state)
        copy_s = time.perf_counter() - t0

        def _write():
            try:
                t1 = time.perf_counter()
                tmp = self.dir / f".tmp_step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir()
                np.savez(tmp / "state.npz", **flat)
                manifest = {"step": step, **(meta or {}),
                            "bfloat16": sorted(bf16)}
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)       # atomic publish
                self._gc()
                self.last_save = {
                    "step": step,
                    "bytes": sum(f.stat().st_size for f in final.iterdir()),
                    "copy_s": copy_s,
                    "write_s": time.perf_counter() - t1}
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def steps(self) -> list:
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, template: PyTree) -> tuple:
        """Returns (state, manifest): ``template``'s tree (its leaves are
        tensors, of any device, ``meta`` included) with each leaf read
        from the checkpoint, in the template leaf's dtype and on its
        device.  Raises ``KeyError`` for a leaf the checkpoint lacks and
        ``ValueError`` for one of another shape."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "state.npz") as z:
            names = set(z.files)

            def leaf(path, t):
                k = _key(path)
                if k not in names:
                    raise KeyError(f"checkpoint missing leaf {k}")
                arr = z[k]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{arr.shape} vs {tuple(t.shape)}")
                return _from_numpy(arr, t)

            state = tree_map_with_path(leaf, template)
        return state, manifest
