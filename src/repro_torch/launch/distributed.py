"""Multi-process initialization for serving: topology and the control plane.

Port of ``repro.launch.distributed``.  The topology — coordinator
address, process count and process id — comes from flags or from the
reference's environment trio (``JAX_COORDINATOR_ADDRESS``,
``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``: one set of shell exports
drives both launchers) and is validated with readable errors by
:func:`resolve_spec` before anything touches a device.

:func:`initialize_distributed` then brings up one of two modes:

* ``mode="coordination"`` — the serving path.  Process 0 hosts a
  ``torch.distributed.TCPStore`` at the coordinator address; every other
  process connects to it.  That key-value store (plus barriers built on
  it) is the whole of what crosses processes: round specs, logit shards,
  warmup broadcasts.  There is no process group and no NCCL, so two
  processes may share one card (NCCL refuses two ranks on one GPU), and
  every process keeps its local devices and kernel libraries to itself.
* ``mode="global"`` — the default ``torch.distributed`` process group
  over every process (``nccl`` on a card, ``gloo`` on the CPU), rendezvous
  at ``tcp://<coordinator>``: what an LM mesh (``launch/mesh.py``'s
  ``make_lm_mesh``) and its collectives need.  NCCL refuses two ranks on
  one GPU, so a global group needs one card per process.

Importing this module imports no torch; the store and the group are
created inside :func:`initialize_distributed`.
"""
from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

ENV_COORDINATOR = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

# the store's server refuses a value above 8 MiB; larger values travel in
# chunks of this size
CHUNK_BYTES = 4 << 20
CONNECT_TIMEOUT_S = 300


class DistributedConfigError(ValueError):
    """Raised when the coordinator/process topology is missing or
    inconsistent.  The message always says which flag/env var to set."""


@dataclass(frozen=True)
class DistributedSpec:
    """A validated multi-process topology: who coordinates, how many
    processes participate, and which one this is."""

    coordinator_address: str
    num_processes: int
    process_id: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    def env_exports(self) -> Dict[str, str]:
        """The env-var form of this spec (what ``env.configure`` exports
        so child processes resolve the same topology)."""
        return {
            ENV_COORDINATOR: self.coordinator_address,
            ENV_NUM_PROCESSES: str(self.num_processes),
            ENV_PROCESS_ID: str(self.process_id),
        }


def _parse_int(value, name: str) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        raise DistributedConfigError(
            f"{name} must be an integer, got {value!r}") from None


def resolve_spec(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 env: Optional[Mapping[str, str]] = None) -> DistributedSpec:
    """Merge explicit values with the environment into a validated spec.

    Explicit arguments win over env vars (``JAX_COORDINATOR_ADDRESS``,
    ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID``).  Raises
    :class:`DistributedConfigError` with an actionable message when the
    topology is missing a piece or internally inconsistent.
    """
    if env is None:
        env = os.environ
    addr = coordinator_address or env.get(ENV_COORDINATOR)
    if not addr:
        raise DistributedConfigError(
            "no coordinator address: pass --coordinator HOST:PORT or set "
            f"{ENV_COORDINATOR}")
    if ":" not in addr or not addr.rsplit(":", 1)[1].isdigit():
        raise DistributedConfigError(
            f"coordinator address {addr!r} is not HOST:PORT")
    if num_processes is None:
        raw = env.get(ENV_NUM_PROCESSES)
        if raw is None:
            raise DistributedConfigError(
                "process count unknown: pass --num-processes or set "
                f"{ENV_NUM_PROCESSES}")
        num_processes = _parse_int(raw, ENV_NUM_PROCESSES)
    if process_id is None:
        raw = env.get(ENV_PROCESS_ID)
        if raw is None:
            raise DistributedConfigError(
                "process id unknown: pass --process-id or set "
                f"{ENV_PROCESS_ID}")
        process_id = _parse_int(raw, ENV_PROCESS_ID)
    num_processes = _parse_int(num_processes, "num_processes")
    process_id = _parse_int(process_id, "process_id")
    if num_processes < 1:
        raise DistributedConfigError(
            f"num_processes must be >= 1, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise DistributedConfigError(
            f"process_id {process_id} out of range for "
            f"num_processes={num_processes} (want 0..{num_processes - 1})")
    return DistributedSpec(coordinator_address=addr,
                           num_processes=num_processes,
                           process_id=process_id)


class CoordinationClient:
    """The control plane over a ``TCPStore``: namespaced keys, values of
    any size, reads with a timeout and barriers.  Compute never goes
    through this object — it moves round specs, logit shards and warmup
    broadcasts.

    A value is written as its chunks (``key#0``, ``key#1``, ...) and then
    ``key`` holding the chunk count, so a reader that sees ``key`` sees
    the whole value.  Keys are written once."""

    def __init__(self, store, spec: DistributedSpec,
                 namespace: str = "repro"):
        self._store = store
        self.spec = spec
        self._ns = namespace

    def _key(self, key: str) -> str:
        return f"{self._ns}/{key}"

    def _wait(self, key: str, timeout_ms: int) -> None:
        from torch.distributed import DistStoreError
        try:
            self._store.wait([key], datetime.timedelta(
                milliseconds=timeout_ms))
        except DistStoreError as exc:
            raise TimeoutError(f"coordination: no {key!r} within "
                               f"{timeout_ms} ms ({exc})") from None

    def set(self, key: str, value: Union[str, bytes]) -> None:
        data = value.encode() if isinstance(value, str) else bytes(value)
        n = max(1, -(-len(data) // CHUNK_BYTES))
        for i in range(n):
            self._store.set(self._key(f"{key}#{i}"),
                            data[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES])
        self._store.set(self._key(key), str(n))

    def get(self, key: str, timeout_ms: int = 60_000) -> bytes:
        """The value at ``key``, waiting up to ``timeout_ms`` for it to
        appear (``TimeoutError`` after that)."""
        self._wait(self._key(key), timeout_ms)
        n = int(self._store.get(self._key(key)))
        return b"".join(self._store.get(self._key(f"{key}#{i}"))
                        for i in range(n))

    def barrier(self, name: str, timeout_ms: int = 60_000) -> None:
        """Return once every process of the spec has reached ``name``.
        Process 0, which hosts the store, returns last: after every other
        process has seen the barrier open, so none loses the store while
        it waits."""
        n = self.spec.num_processes
        if self._store.add(self._key(f"{name}/arrived"), 1) == n:
            self._store.set(self._key(f"{name}/done"), "1")
        self._wait(self._key(f"{name}/done"), timeout_ms)
        left = self._store.add(self._key(f"{name}/left"), 1)
        if not self.spec.is_coordinator:
            return
        deadline = time.monotonic() + timeout_ms / 1e3
        while left < n:
            if time.monotonic() > deadline:
                raise TimeoutError(f"coordination: {n - left} process(es) "
                                   f"never left barrier {name!r}")
            time.sleep(0.005)
            left = self._store.add(self._key(f"{name}/left"), 0)


def initialize_distributed(spec: DistributedSpec, *,
                           mode: str = "global", device="cuda",
                           timeout_s: float = CONNECT_TIMEOUT_S
                           ) -> Optional[CoordinationClient]:
    """Bring up the distributed runtime per ``spec``.

    ``mode="coordination"`` hosts the key-value store on process 0
    (``TCPStore(is_master=True)``, not waiting for the others, so a worker
    may join late) or connects to it, and returns a
    :class:`CoordinationClient`.  ``mode="global"`` brings up the default
    process group, ``rank=process_id`` of ``world_size=num_processes``,
    over ``init_method=tcp://<coordinator>`` (``nccl`` where ``device`` is
    ``cuda``, ``gloo`` on the CPU), and returns None; a peer that does not
    join within ``timeout_s`` raises ``TimeoutError``.  A single-process
    spec returns None in either mode, and brings up nothing — callers take
    the non-distributed path.
    """
    if mode not in ("global", "coordination"):
        raise ValueError(f"unknown mode {mode!r}")
    if spec.num_processes == 1:
        return None
    timeout = datetime.timedelta(seconds=timeout_s)
    if mode == "global":
        import torch
        import torch.distributed as dist
        kind = torch.device(device).type
        if kind == "cuda":
            torch.cuda.set_device(spec.process_id % torch.cuda.device_count())
        try:
            dist.init_process_group(
                "nccl" if kind == "cuda" else "gloo",
                init_method=f"tcp://{spec.coordinator_address}",
                rank=spec.process_id, world_size=spec.num_processes,
                timeout=timeout)
        except dist.DistError as exc:
            raise TimeoutError(
                f"process {spec.process_id} of {spec.num_processes}: the "
                f"process group at {spec.coordinator_address} did not form "
                f"within {timeout_s:g} s ({str(exc).splitlines()[0]})"
            ) from None
        return None
    from torch.distributed import TCPStore
    host, port = spec.coordinator_address.rsplit(":", 1)
    store = TCPStore(host, int(port), world_size=spec.num_processes,
                     is_master=spec.is_coordinator, timeout=timeout,
                     wait_for_workers=False)
    return CoordinationClient(store, spec)


def shutdown_distributed() -> None:
    """Destroy the default process group if it is up (idempotent)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
