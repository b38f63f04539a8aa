"""Cross-process round execution over the coordination key-value store.

Port of ``repro.serving.vision.multiproc``.  Process 0 runs the whole
serving brain — admission, queues, the round planner, the pipelined
executor — exactly as in single-process serving, but over a *logical*
device universe spanning every process
(``launch.mesh.make_multiprocess_data_mesh``).  This module is the thin
control plane that makes those logical rounds physical:

* the coordinator publishes each planned round (model keys, padded
  batches, device-group ids) on a sequenced message channel in the
  ``TCPStore`` that ``launch.distributed`` brings up;
* every process — coordinator included — runs its *addressable stripe*
  of each group with plain process-local ``ModelRegistry.apply`` (no
  collective anywhere, no process group);
* workers publish their logit shards back through the store and the
  coordinator's completer stitches them into the full batch.

Two processes x 2 devices give the same results as one process over a
4-device mesh: aligned groups give every process identically numbered
local devices and the same stripe shapes, so each row runs the same
kernels at the same shapes either way.  A worker that shares the
coordinator's kernel build directory builds nothing: the coordinator's
warmup builds every library before the warmup broadcast tells workers to
warm their stripes (pure build-cache hits, asserted by
``scripts/multiprocess_check_torch.py``).

A message is a JSON header plus the raw bytes of its arrays (not base64
inside JSON, as the reference sends them); a bucket of letterboxed
224 px inputs is a few MB, which the store's client chunks.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.mesh import LogicalDevice, MultiprocessDataMesh

ROUND_TIMEOUT_MS = 120_000
WORKER_IDLE_TIMEOUT_MS = 600_000
MESH_TIMEOUT_MS = 60_000


def _pack(header: Dict, arrays: Sequence[np.ndarray] = ()) -> bytes:
    """One message: an 8-byte header length, the JSON header (with each
    array's shape and dtype under ``"arrays"``), then the arrays' bytes."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    head = json.dumps(dict(header, arrays=[
        {"shape": list(a.shape), "dtype": str(a.dtype)} for a in arrays]
    )).encode()
    return b"".join([struct.pack("<Q", len(head)), head]
                    + [a.tobytes() for a in arrays])


def _unpack(payload: bytes) -> Tuple[Dict, List[np.ndarray]]:
    (n,) = struct.unpack_from("<Q", payload)
    header = json.loads(payload[8:8 + n])
    arrays, off = [], 8 + n
    for spec in header.pop("arrays"):
        dtype = np.dtype(spec["dtype"])
        size = int(np.prod(spec["shape"])) * dtype.itemsize
        arrays.append(np.frombuffer(payload, dtype, offset=off,
                                    count=size // dtype.itemsize)
                      .reshape(spec["shape"]).copy())
        off += size
    return header, arrays


@dataclasses.dataclass(frozen=True)
class LocalExec:
    """One process's share of a round part: the local devices to run on,
    the group positions they own, and the per-position row count.
    ``positions`` is None for replicated (coordinator-only) execution of
    a bucket that does not divide the group width."""

    devices: Tuple
    positions: Optional[List[int]]
    local_bucket: int
    rows_per_position: int


def local_exec_plan(mesh: MultiprocessDataMesh,
                    group: Sequence[LogicalDevice], bucket: int,
                    process_id: int = -1) -> Optional[LocalExec]:
    """How one process executes a ``bucket``-row batch assigned to
    ``group`` — or None when it has nothing to run.

    Striped case (``bucket % len(group) == 0``): group position ``j`` owns
    rows ``[j*m, (j+1)*m)`` with ``m = bucket // len(group)``; each
    process runs its positions' rows on its stripe devices.  Aligned
    groups give every process identically-numbered local devices, so the
    entry — and the stripe shapes — are the same everywhere.  Replicated
    case: the full bucket runs on the coordinator's stripe only."""
    pid = mesh.process_id if process_id < 0 else process_id
    width = len(group)
    devs, positions = mesh.stripe(group, pid)
    if width > 1 and bucket % width == 0:
        if not positions:
            return None
        m = bucket // width
        return LocalExec(devs, list(positions), m * len(positions), m)
    if pid != 0:
        return None
    return LocalExec(devs, None, bucket, bucket)


def slice_local_rows(batch: np.ndarray, plan: LocalExec) -> np.ndarray:
    """The rows of a full padded batch this process executes, stacked in
    position order (the order ``stitch_shards`` inverts)."""
    if plan.positions is None:
        return batch
    m = plan.rows_per_position
    return np.concatenate([batch[j * m:(j + 1) * m]
                           for j in plan.positions], axis=0)


def stitch_shards(bucket: int,
                  shards: Sequence[Tuple[LocalExec, np.ndarray]]
                  ) -> np.ndarray:
    """Reassemble the full-batch logits from per-process shards (the
    inverse of ``slice_local_rows`` across all participating processes)."""
    first = shards[0][1]
    out = np.empty((bucket,) + first.shape[1:], dtype=first.dtype)
    for plan, arr in shards:
        if plan.positions is None:
            if arr.shape[0] != bucket:
                raise ValueError(f"replicated shard has {arr.shape[0]} "
                                 f"rows, not the bucket's {bucket}")
            return np.asarray(arr)
        m = plan.rows_per_position
        for i, j in enumerate(plan.positions):
            out[j * m:(j + 1) * m] = arr[i * m:(i + 1) * m]
    return out


class PartHandle:
    """Future-like handle for one round part dispatched cross-process:
    the local shard is already queued on this process's devices; the
    remote shards are gathered (and stitched) on ``materialize``."""

    def __init__(self, coord: "MultiprocessCoordinator", round_no: int,
                 part_idx: int, bucket: int, plan: LocalExec,
                 local_out, remote_pids: Sequence[int]):
        self._coord = coord
        self._round = round_no
        self._idx = part_idx
        self._bucket = bucket
        self._plan = plan
        self._local_out = local_out
        self._remote_pids = list(remote_pids)
        self._result: Optional[np.ndarray] = None

    def materialize(self) -> np.ndarray:
        if self._result is None:
            self._result = self._coord._gather(
                self._round, self._idx, self._bucket, self._plan,
                self._local_out, self._remote_pids)
        return self._result


class MultiprocessCoordinator:
    """Process 0's side of the cross-process round protocol.

    Owns the sequenced message channel (``msg/{seq}``: warmup broadcasts,
    round specs, the stop sentinel), dispatches the coordinator's own
    stripes through the registry, and gathers worker logit shards.  One
    instance is handed to ``VisionServeEngine`` as its dispatch hook.
    ``round_timeout_ms`` bounds the wait for a worker's shard: a dead
    worker fails the round's requests after it."""

    def __init__(self, client, mesh: MultiprocessDataMesh, registry,
                 metrics=None, round_timeout_ms: int = ROUND_TIMEOUT_MS):
        if mesh.process_id != 0:
            raise ValueError("MultiprocessCoordinator runs on process 0 "
                             "only")
        self.client = client
        self.mesh = mesh
        self.registry = registry
        self.metrics = metrics
        self.round_timeout_ms = round_timeout_ms
        self._seq = 0
        self._round = 0
        self._lock = threading.Lock()
        self._by_id = {d.id: d for d in mesh.universe}

    # -- topology ----------------------------------------------------------
    @property
    def universe(self) -> Tuple[LogicalDevice, ...]:
        return self.mesh.universe

    def group_by_ids(self, ids: Sequence[int]) -> Tuple[LogicalDevice, ...]:
        return tuple(self._by_id[i] for i in ids)

    def check_mesh_agreement(self, timeout_ms: int = MESH_TIMEOUT_MS) -> str:
        """Publish this process's mesh fingerprint and require every
        worker's to match (workers run ``publish_mesh_fingerprint``)."""
        fp = self.mesh.fingerprint()
        self.client.set("mesh/0", fp)
        for pid in range(1, self.mesh.num_processes):
            other = self.client.get(f"mesh/{pid}", timeout_ms).decode()
            if other != fp:
                raise RuntimeError(
                    f"mesh disagreement: process {pid} built {other}, "
                    f"coordinator built {fp} (differing device counts or "
                    "REPRO_TORCH_VIRTUAL_DEVICES between processes)")
        return fp

    # -- message channel ---------------------------------------------------
    def _publish(self, header: Dict,
                 arrays: Sequence[np.ndarray] = ()) -> int:
        payload = _pack(header, arrays)
        with self._lock:
            seq = self._seq
            self._seq += 1
        self.client.set(f"msg/{seq}", payload)
        return len(payload)

    def broadcast_warmup(self, fingerprint: str,
                         entries: Sequence[Tuple]) -> None:
        """Tell workers which (model, bucket, group-ids) entries to warm —
        after the coordinator warmed them, so every worker's kernel
        libraries are already built."""
        self._publish({
            "type": "warmup", "fingerprint": fingerprint,
            "entries": [[k, b, list(ids) if ids else None]
                        for k, b, ids in entries]})

    def begin_round(self, parts: Sequence[Tuple[str, np.ndarray,
                                                Sequence[int]]]) -> int:
        """Publish one round spec (every part's model key, padded batch,
        and device-group ids); returns the round number workers will file
        their shards under."""
        with self._lock:
            round_no = self._round
            self._round += 1
        header = {"type": "round", "round": round_no, "parts": [
            {"idx": idx, "key": key, "group_ids": list(group_ids)}
            for idx, (key, _, group_ids) in enumerate(parts)]}
        nbytes = self._publish(header, [np.asarray(batch, np.float32)
                                        for _, batch, _ in parts])
        if self.metrics is not None:
            self.metrics.on_broadcast(nbytes)
        return round_no

    def stop_workers(self, timeout_ms: int = MESH_TIMEOUT_MS) -> None:
        """Publish the stop sentinel and rendezvous at the shutdown
        barrier (workers finish their last round, then join it)."""
        self._publish({"type": "stop"})
        self.client.barrier("shutdown", timeout_ms)

    # -- dispatch / gather -------------------------------------------------
    def dispatch(self, round_no: int, part_idx: int, key: str,
                 batch: np.ndarray,
                 group: Sequence[LogicalDevice]) -> PartHandle:
        """Queue the coordinator's stripe of one part (``registry.apply``
        returns once the work is queued) and hand back the gather
        handle."""
        bucket = int(np.asarray(batch).shape[0])
        plan = local_exec_plan(self.mesh, group, bucket)
        local = self.registry.apply(key, slice_local_rows(batch, plan),
                                    devices=plan.devices)
        remote = [] if plan.positions is None else sorted(
            {d.process for d in group} - {0})
        return PartHandle(self, round_no, part_idx, bucket, plan, local,
                          remote)

    def _gather(self, round_no: int, part_idx: int, bucket: int,
                plan: LocalExec, local_out,
                remote_pids: Sequence[int]) -> np.ndarray:
        shards = [(plan, np.asarray(local_out.materialize()))]
        nbytes = 0
        for pid in remote_pids:
            payload = self.client.get(
                f"shard/{round_no}/{part_idx}/{pid}", self.round_timeout_ms)
            nbytes += len(payload)
            header, (arr,) = _unpack(payload)
            rplan = local_exec_plan(self.mesh, self.group_by_ids(
                header["group_ids"]), bucket, process_id=pid)
            shards.append((rplan, arr))
        if self.metrics is not None and remote_pids:
            self.metrics.on_shard_gather(len(remote_pids), nbytes)
        return stitch_shards(bucket, shards)


def publish_mesh_fingerprint(client, mesh: MultiprocessDataMesh,
                             timeout_ms: int = MESH_TIMEOUT_MS) -> str:
    """Worker side of mesh agreement: publish our fingerprint, then check
    it against the coordinator's (fails loudly on topology drift)."""
    fp = mesh.fingerprint()
    client.set(f"mesh/{mesh.process_id}", fp)
    coord_fp = client.get("mesh/0", timeout_ms).decode()
    if coord_fp != fp:
        raise RuntimeError(
            f"mesh disagreement: this process built {fp}, coordinator "
            f"built {coord_fp} (differing device counts or "
            "REPRO_TORCH_VIRTUAL_DEVICES)")
    return fp


def run_worker(client, mesh: MultiprocessDataMesh, registry, *,
               idle_timeout_ms: int = WORKER_IDLE_TIMEOUT_MS) -> Dict:
    """Worker follower loop: consume the coordinator's message channel in
    order — warm the broadcast entries, execute our stripe of each round,
    publish logit shards — until the stop sentinel.  Returns the worker's
    accounting dict (the multiprocess check reads its warm join from the
    kernel build cache's counters)."""
    if mesh.process_id == 0:
        raise ValueError("run_worker is for non-coordinator processes")
    stats = {"rounds_seen": 0, "parts_executed": 0, "parts_skipped": 0,
             "warmup_entries_warmed": 0, "warmup_entries_skipped": 0,
             "shard_bytes_out": 0, "warmup_fingerprint": None}
    by_id = {d.id: d for d in mesh.universe}
    seq = 0
    while True:
        msg, arrays = _unpack(client.get(f"msg/{seq}", idle_timeout_ms))
        seq += 1
        kind = msg["type"]
        if kind == "stop":
            break
        if kind == "warmup":
            stats["warmup_fingerprint"] = msg["fingerprint"]
            # same combined stamp the coordinator's manifest carries:
            # backend fingerprint + mesh topology fingerprint
            local_fp = (f"{registry.backend_fingerprint()}:"
                        f"{mesh.fingerprint()}")
            if local_fp != msg["fingerprint"]:
                raise RuntimeError(
                    f"warmup fingerprint mismatch: coordinator "
                    f"{msg['fingerprint']}, worker {local_fp} (model set "
                    "or torch/device drift between processes)")
            for key, bucket, ids in msg["entries"]:
                if ids is None:
                    registry.warm_entry(key, bucket)
                    stats["warmup_entries_warmed"] += 1
                    continue
                group = tuple(by_id[i] for i in ids)
                plan = local_exec_plan(mesh, group, bucket)
                if plan is None:
                    stats["warmup_entries_skipped"] += 1
                    continue
                registry.warm_entry(key, plan.local_bucket,
                                    devices=plan.devices)
                stats["warmup_entries_warmed"] += 1
            continue
        if kind != "round":
            raise ValueError(f"unknown message type {kind!r}")
        stats["rounds_seen"] += 1
        round_no = msg["round"]
        for part, batch in zip(msg["parts"], arrays):
            group = tuple(by_id[i] for i in part["group_ids"])
            plan = local_exec_plan(mesh, group, batch.shape[0])
            if plan is None:
                stats["parts_skipped"] += 1
                continue
            shard = registry.apply(part["key"],
                                   slice_local_rows(batch, plan),
                                   devices=plan.devices).materialize()
            payload = _pack({"group_ids": part["group_ids"]}, [shard])
            client.set(f"shard/{round_no}/{part['idx']}/{mesh.process_id}",
                       payload)
            stats["shard_bytes_out"] += len(payload)
            stats["parts_executed"] += 1
    client.barrier("shutdown", MESH_TIMEOUT_MS)
    return stats
