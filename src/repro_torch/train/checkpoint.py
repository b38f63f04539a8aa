"""Fault-tolerant checkpointing: atomic, async, elastic re-shard on restore.

Port of ``repro.train.checkpoint``, in the reference's format: one
``state.npz`` of flattened leaves keyed by their ``/``-joined paths (dict
keys, list indices) and a ``manifest.json`` (step, data cursor).  Writes
go to a temp dir and are renamed atomically (a crash mid-write never
corrupts the latest checkpoint); one save is in flight at a time, on a
background thread, and its error is raised at ``wait()``.  The state is
copied to the host before ``save`` returns, so the caller may update its
tensors in place at once.

A state of DTensors (a trainer over a mesh) is saved in the same format:
every rank gathers each leaf (``full_tensor()``, a collective, in the
tree's order), process 0 alone writes and renames, and every rank's
``wait()`` (and a blocking ``save``) returns only after the rename, with
process 0's write error raised on every rank.  So a checkpoint saved from
a mesh restores into the reference's ``CheckpointManager`` and into a
process without a mesh.  ``restore`` places each leaf as the caller's
shardings (or the template leaf's placements) say, each rank keeping its
own shard of the whole leaf it reads: the mesh may differ in shape from
the one that saved (the reference's elastic restart).

bfloat16 leaves are stored as their ``int16`` bit pattern (numpy has no
bfloat16 dtype of its own) and listed in the manifest under
``"bfloat16"``; ``restore`` reads them back bit for bit.  It also reads the
reference's npz, whose bfloat16 leaves arrive as 2-byte void (``|V2``)
arrays: the same bits.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels._build import is_dtensor
from repro_torch.launch.mesh import local_device
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

PyTree = Any

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (always a copy: the caller may write ``t`` in
    place while the save thread reads this); bfloat16 as its int16 bits.
    A DTensor is gathered whole first (a collective)."""
    if is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a host tensor of ``like``'s dtype.  A bfloat16 leaf
    stored as 2-byte bits (int16, uint16, or the reference's void ``|V2``)
    is viewed, not converted."""
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and \
            arr.dtype.kind in "iuV":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)


def _place(t: torch.Tensor, like, sharding, device) -> torch.Tensor:
    """The host tensor ``t`` placed as ``sharding`` (a ``NamedSharding``)
    says, else as ``like``'s placements if it is a DTensor, else on
    ``device`` (``like``'s device by default).  A DTensor keeps this
    rank's shard of ``t``; nothing is sent."""
    if sharding is not None:
        mesh, placements = sharding.mesh, sharding.placements
    elif is_dtensor(like):
        mesh, placements = like.device_mesh, like.placements
    else:
        return t.to(like.device if device is None else device)
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.to(local_device(mesh)), mesh, placements,
                             src_data_rank=None)


class _Npz:
    """The arrays of an ``.npz``, each read on demand.  A member stored
    uncompressed (``np.savez`` writes them so) is read straight from its
    offset in the file with ``np.fromfile``, one copy at the file system's
    rate (``np.load`` reads through zipfile's checked stream: 26.8 GB in
    about 60 s on the H100's host); any other member through ``np.load``."""

    def __init__(self, path):
        self._path = path
        self._zip = zipfile.ZipFile(path)
        self._npz = np.load(path)
        self.files = self._npz.files

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._npz.close()
        self._zip.close()

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._zip.getinfo(key + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            return self._npz[key]
        with open(self._path, "rb") as f:
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(name_len + extra_len, os.SEEK_CUR)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if fortran or dtype.hasobject:
                return self._npz[key]
            count = int(np.prod(shape))
            arr = np.fromfile(f, dtype=dtype, count=count)
        if arr.size != count:
            raise ValueError(f"checkpoint leaf {key}: {arr.size} of "
                             f"{count} elements in the file")
        return arr.reshape(shape)


def _is_writer() -> bool:
    """Process 0 of the default process group (or a process without
    one)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the device of the last save's collective state (a DTensor state),
        # until every rank has passed its wait()
        self._collective: Optional[torch.device] = None
        # the last save that finished: step, bytes, host-copy and write
        # seconds
        self.last_save: Optional[dict] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: PyTree, *, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Copy ``state`` to the host and write it as step ``step`` (on a
        background thread unless ``blocking``).  With DTensor leaves every
        rank of the default process group must call this with the same
        tree: each leaf is gathered on every rank, and only process 0
        writes."""
        self.wait()                     # one in-flight save at a time
        t0 = time.perf_counter()
        writer = _is_writer()
        flat, bf16 = {}, []
        dtensors = [t for t in tree_leaves(state) if is_dtensor(t)]
        if dtensors:
            self._collective = local_device(dtensors[0].device_mesh)

        def host(path, t):
            k = _key(path)
            if t.dtype == torch.bfloat16:
                bf16.append(k)
            arr = _to_numpy(t)
            if writer:
                flat[k] = arr

        tree_map_with_path(host, state)
        copy_s = time.perf_counter() - t0
        if not writer:
            if blocking:
                self.wait()
            return

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
        """Return once the save in flight has been renamed into place;
        raise its error.  After a collective save every rank waits for
        process 0's rename, and every rank raises if process 0's write
        failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._collective is not None:
            import torch.distributed as dist
            failed = torch.tensor([self._error is not None], dtype=torch.int32,
                                  device=self._collective)
            self._collective = None
            dist.all_reduce(failed, op=dist.ReduceOp.MAX)
            if failed.item() and self._error is None:
                raise RuntimeError("checkpoint: process 0's write failed")
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

    def restore(self, step: int, template: PyTree,
                shardings: Optional[PyTree] = None,
                device=None) -> tuple:
        """Returns (state, manifest): ``template``'s tree (its leaves are
        tensors of any device, ``meta`` included, or DTensors: shapes,
        dtypes and placements) with each leaf read from the checkpoint in
        the template leaf's dtype.  A leaf is placed as its
        ``NamedSharding`` in ``shardings`` (a tree shaped as ``template``)
        says, else as the template leaf's placements if it is a DTensor,
        else on ``device`` (default: the template leaf's device).  The mesh
        may have another shape than the one that saved.  Raises
        ``KeyError`` for a leaf the checkpoint lacks and ``ValueError`` for
        one of another shape."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        if shardings is None:
            shardings = tree_map(lambda _: None, template)
        with _Npz(d / "state.npz") as z:
            names = set(z.files)

            def leaf(path, t, sharding):
                k = _key(path)
                if k not in names:
                    raise KeyError(f"checkpoint missing leaf {k}")
                arr = z[k]
                if tuple(arr.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{arr.shape} vs {tuple(t.shape)}")
                return _place(_from_numpy(arr, t), t, sharding, device)

            state = tree_map_with_path(leaf, template, shardings)
        return state, manifest
