"""The vision-serving data mesh, and its multi-process universe.

Port of the serving half of ``repro.launch.mesh``.  A device of the
port's mesh is a :class:`MeshDevice`: a stable id, the physical
``torch.device`` it runs on and a CUDA stream of its own (None on the
CPU).  :func:`make_data_mesh` builds a 1-D ``"data"`` mesh of them:

* with ``REPRO_TORCH_VIRTUAL_DEVICES`` unset (``launch.env.configure``
  sets it), mesh device ``i`` is physical device ``i`` and a mesh of N
  needs N of them; it raises a readable ``ValueError`` rather than wrap
  onto fewer;
* with it set to V, up to V logical devices map round-robin onto the
  physical ones.  On one card, V logical devices are V streams of it, so
  one group's stripes overlap on the card; on the CPU they are all
  ``cpu``, as the reference's CPU tests run 8 virtual host devices.

Multi-process serving adds :func:`make_multiprocess_data_mesh`: a global
1-D universe over every process's devices, of which this process holds a
local mesh.  Compute stays process-local (``launch/distributed.py``
brings up a key-value store, no collectives), so the universe is a
*logical* construct: :class:`LogicalDevice` entries carry a stable global
id plus their owning process and local device index, ordered round-robin
across processes — position ``j`` belongs to process ``j % P``.  With
every device-group size a multiple of P (the cost model's
``group_granularity``), any contiguous aligned slice of the universe gives
each process an equal stripe of *identical local device ids*, so every
process runs the same stripe shapes on the same kernels.

LM sharding runs on a second kind of mesh, a ``torch.distributed``
``DeviceMesh`` with named axes (``"data"``, ``"model"`` and, across pods,
``"pod"``) over the ranks of the default process group, one device per
rank: :func:`make_lm_mesh` for any shape, :func:`make_host_mesh` (1x1 on
the local device, bringing up a world-1 group itself) and
:func:`make_production_mesh` (the reference's 16x16 and 2x16x16).  The
sharding policy reads a mesh through :func:`axis_names` and
:func:`axis_size`, which take a ``DeviceMesh`` or any object with the
reference's ``axis_names`` and ``shape`` mapping.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.launch.env import ENV_VIRTUAL_DEVICES


@dataclasses.dataclass(frozen=True, eq=False)
class MeshDevice:
    """One device of a data mesh.  ``id`` is its index in the mesh (what
    device groups, manifests and round specs name), ``device`` the
    physical device it runs on, ``stream`` its own CUDA stream (None on
    the CPU).  Compared by identity: two mesh devices on one card are two
    devices."""

    id: int
    device: torch.device
    stream: Optional["torch.cuda.Stream"] = None

    @property
    def platform(self) -> str:
        return self.device.type

    def __repr__(self) -> str:
        return f"MeshDevice(id={self.id}, device={self.device})"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D ``"data"`` mesh: batches stripe over its devices, parameters
    are copied once per physical device."""

    devices: Tuple[MeshDevice, ...]
    axis_names: Tuple[str, ...] = ("data",)


class LogicalDevice(NamedTuple):
    """One slot in the global serving universe.  ``id`` is the stable
    global id (``process * n_local + local``) used in warmup manifests
    and round specs; ``process``/``local`` locate the physical device."""

    id: int
    process: int
    local: int


@dataclasses.dataclass(frozen=True)
class MultiprocessDataMesh:
    """Global 1-D data universe + this process's addressable shard."""

    local_mesh: object  # this process's DataMesh
    num_processes: int
    process_id: int
    n_local: int
    universe: Tuple[LogicalDevice, ...] = dataclasses.field(default=())

    @property
    def global_size(self) -> int:
        return self.num_processes * self.n_local

    @property
    def universe_ids(self) -> Tuple[int, ...]:
        return tuple(d.id for d in self.universe)

    def local_devices(self) -> Tuple:
        """This process's mesh devices, local-index order."""
        devs = self.local_mesh.devices
        return tuple(getattr(devs, "flat", devs))

    def by_id(self, ids: Sequence[int]) -> Tuple[LogicalDevice, ...]:
        table = {d.id: d for d in self.universe}
        return tuple(table[i] for i in ids)

    def stripe(self, group: Sequence[LogicalDevice],
               process_id: int = -1) -> Tuple[Tuple, List[int]]:
        """The addressable shard of ``group`` for one process: its local
        devices (local-index order) and the positions inside the group
        they own.  For aligned groups the local indices are identical on
        every process."""
        pid = self.process_id if process_id < 0 else process_id
        positions = [j for j, d in enumerate(group) if d.process == pid]
        locals_ = self.local_devices()
        devs = tuple(locals_[group[j].local] for j in positions)
        return devs, positions

    def fingerprint(self) -> str:
        """Topology digest every process must agree on before serving."""
        locals_ = self.local_devices()
        blob = "|".join([
            str(self.num_processes), str(self.n_local),
            locals_[0].platform if locals_ else "none",
            ",".join(str(d.id) for d in locals_),
            ",".join(f"{d.id}:{d.process}:{d.local}"
                     for d in self.universe),
        ])
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def describe(self) -> dict:
        return {
            "num_processes": self.num_processes,
            "process_id": self.process_id,
            "n_local": self.n_local,
            "global_size": self.global_size,
            "mesh_fingerprint": self.fingerprint(),
        }


def logical_universe(num_processes: int,
                     n_local: int) -> Tuple[LogicalDevice, ...]:
    """The global device universe in round-robin (process-interleaved)
    order: position ``j`` -> (process ``j % P``, local ``j // P``).  Any
    contiguous slice whose offset and length are multiples of P then
    spans all processes with equal, identically-numbered local stripes."""
    out = []
    for j in range(num_processes * n_local):
        p, l = j % num_processes, j // num_processes
        out.append(LogicalDevice(id=p * n_local + l, process=p, local=l))
    return tuple(out)


def virtual_device_count(env: Optional[Mapping[str, str]] = None) -> int:
    """``REPRO_TORCH_VIRTUAL_DEVICES`` as a count (0 when unset)."""
    raw = (os.environ if env is None else env).get(ENV_VIRTUAL_DEVICES, "")
    if raw and not raw.isdigit():
        raise ValueError(f"{ENV_VIRTUAL_DEVICES}={raw!r} is not a device "
                         f"count")
    return int(raw or 0)


def physical_devices(device="cuda") -> Tuple[torch.device, ...]:
    """Every physical device of ``device``'s type: the visible cards for
    ``cuda`` (raising without one: there is no CPU fallback), the one
    ``cpu``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),)
    if kind != "cuda":
        raise ValueError(f"no data mesh over {kind} devices")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA data mesh needs a card, and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def make_data_mesh(n_devices: int = 0, device="cuda",
                   env: Optional[Mapping[str, str]] = None) -> DataMesh:
    """1-D data mesh of ``n_devices`` devices (0 = all there are) over the
    physical ``device``s.  This is the vision-serving mesh: batches stripe
    over ``"data"``, parameters are copied once per physical device.
    Logical devices beyond the physical ones need
    ``REPRO_TORCH_VIRTUAL_DEVICES`` (see the module docstring)."""
    phys = physical_devices(device)
    virtual = virtual_device_count(env)
    available = virtual or len(phys)
    n = n_devices or available
    if n > available:
        kind = phys[0].type
        if virtual:
            raise ValueError(
                f"a data mesh of {n} devices needs {n} logical devices, but "
                f"{ENV_VIRTUAL_DEVICES}={virtual}; set it to {n}")
        raise ValueError(
            f"a data mesh of {n} devices needs {n} {kind} devices, but "
            f"{len(phys)} {'is' if len(phys) == 1 else 'are'} visible; set "
            f"{ENV_VIRTUAL_DEVICES}={n} to map {n} logical devices onto "
            f"{'it' if len(phys) == 1 else 'them'}")
    devices = []
    for i in range(n):
        dev = phys[i % len(phys)]
        stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        devices.append(MeshDevice(i, dev, stream))
    return DataMesh(tuple(devices))


def make_multiprocess_data_mesh(num_processes: int, process_id: int,
                                n_local_devices: int = 0, device="cuda",
                                env: Optional[Mapping[str, str]] = None
                                ) -> MultiprocessDataMesh:
    """Global 1-D ``"data"`` universe over all processes' devices, with
    this process's addressable shard as a local :class:`DataMesh`.

    Every process calls this with the same ``num_processes`` and its own
    ``process_id``; ``n_local_devices`` counts *per-process* devices
    (0 = all local).  Two processes x N virtual devices run on one card
    or one CPU.  All processes must bring the same per-process device
    count; agreement is checked by exchanging
    :meth:`MultiprocessDataMesh.fingerprint` at startup."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} out of range for "
                         f"num_processes={num_processes}")
    local = make_data_mesh(n_local_devices, device, env)
    n = len(local.devices)
    return MultiprocessDataMesh(
        local_mesh=local, num_processes=num_processes,
        process_id=process_id, n_local=n,
        universe=logical_universe(num_processes, n))


LM_AXES = ("data", "model")
PRODUCTION_AXES = ("pod", "data", "model")


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, else
    its ``axis_names`` (the vision ``DataMesh``, a stand-in mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name``: a ``DeviceMesh``'s ``size(dim)``, else
    ``mesh.shape[name]`` as on a JAX mesh."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh.size(mesh.mesh_dim_names.index(name))
    return mesh.shape[name]


def make_lm_mesh(shape: Sequence[int], device="cuda",
                 names: Sequence[str] = LM_AXES):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the ranks of
    the default process group (row-major, one device per rank), on
    ``device``'s type.  The group's world size must be the mesh's size: a
    readable ``ValueError`` otherwise, never a wrap onto fewer ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(int(n) for n in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} against axes {names}")
    size = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if size != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} {names} mesh needs {size} "
            f"processes, one device each, but the process group has "
            f"{world}; start {size} processes and call "
            f"launch.distributed.initialize_distributed(spec, "
            f"mode='global') in each")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: 16x16 ``("data", "model")``, or
    2x16x16 ``("pod", "data", "model")`` with ``multi_pod``."""
    if multi_pod:
        return make_lm_mesh((2, 16, 16), device, PRODUCTION_AXES)
    return make_lm_mesh((16, 16), device, LM_AXES)


def make_host_mesh(device="cuda"):
    """1x1 ``("data", "model")`` mesh on the real local device.  With no
    process group it brings up a world-1 group first (``nccl`` for
    ``cuda``, ``gloo`` on the CPU, over an in-process store)."""
    import torch.distributed as dist
    kind = torch.device(device).type
    if not dist.is_initialized():
        if kind == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return make_lm_mesh((1, 1), device, LM_AXES)


def local_device(mesh) -> torch.device:
    """The device this rank holds of an LM mesh: the current card of a
    ``cuda`` mesh, else the mesh's device type."""
    kind = mesh.device_type
    return torch.device(kind, torch.cuda.current_device()) \
        if kind == "cuda" else torch.device(kind)


def data_axes(mesh) -> tuple:
    """The axes a global batch is sharded over (pod acts as outer data)."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
