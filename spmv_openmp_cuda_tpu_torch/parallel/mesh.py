"""Device mesh of the multi-device paths, in one process or across several.

Counterpart of spmv_openmp_cuda_tpu/parallel/mesh.py. The JAX package runs
shard_map over a jax.sharding.Mesh, whose devices may belong to several
processes (jax.distributed); its tests run 8 virtual CPU devices in one. The
port keeps that shape: a (rows, cols) grid of torch.devices with the axes

  "rows" — output-row data parallelism (the row-block OMP/CUDA analogs),
  "cols" — contraction-axis parallelism (the 2D-tiles partial-sum analog).

A device may appear more than once: n shards on one card are the counterpart
of JAX's virtual devices, and their exchanges are copies within the card. On
a host with several cards each shard has its own, and the exchanges are
peer copies (parallel/collectives.py).

Under a torch.distributed group of W > 1 processes (started by the caller,
gloo or NCCL; init_distributed starts one), make_mesh joins every rank's
devices, in rank order, into one grid, and records each device's owning
rank. Each process then holds, prepares and computes only the shards on its
own devices, and the collectives exchange the rest through torch.distributed.

A sharded value is a list with one entry per distinct shard of a mesh axis:
the shard's tensor on its device where this process owns it, None where
another process does. shard, row_shards and replicate cut or copy a whole
tensor, which every process holds (as jax.device_put does a host array),
onto the devices of an axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

ROWS = "rows"
COLS = "cols"


class RankDevice(NamedTuple):
    """A device of the mesh with its owning process: the counterpart of a
    jax.Device and its process_index (Mesh.global_devices)."""

    rank: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (rows, cols) grid of torch.devices; devices may repeat. owners is
    the grid of the devices' ranks under a process group (None: every device
    is this process's); rank is this process's."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (ROWS, COLS)
    owners: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return {ROWS: len(self.devices), COLS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape[ROWS] * self.shape[COLS]

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None

    def flat(self) -> List[torch.device]:
        """The devices in row-major order."""
        return [d for row in self.devices for d in row]

    def global_devices(self) -> List[RankDevice]:
        """Every process's devices, with their ranks, in row-major order
        (the counterpart of jax.devices() under jax.distributed)."""
        owners = self.owners or tuple((self.rank,) * len(row) for row in self.devices)
        return [RankDevice(r, d) for orow, drow in zip(owners, self.devices)
                for r, d in zip(orow, drow)]

    def _line(self, grid, axis: str) -> list:
        if axis == ROWS:
            return [row[0] for row in grid]
        if axis == COLS:
            return list(grid[0])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of one line along `axis` (the first row or the first
        column): where the port computes the shards of a value sharded over
        that axis. The other axis holds replicas, which compute nothing the
        first does not."""
        return self._line(self.devices, axis)

    def axis_owners(self, axis: str) -> List[int]:
        """The rank owning each shard of `axis`."""
        if self.owners is None:
            return [self.rank] * self.shape[axis]
        return self._line(self.owners, axis)

    def is_local(self, axis: str) -> List[bool]:
        """Whether this process holds each shard of `axis`."""
        return [r == self.rank for r in self.axis_owners(axis)]

    def home(self, axis: str) -> torch.device:
        """Where a value joined over `axis` lands in this process: the device
        of its first own shard of the axis, else its first device of the
        mesh."""
        for dev, mine in zip(self.axis_devices(axis), self.is_local(axis)):
            if mine:
                return dev
        return next(g.device for g in self.global_devices() if g.rank == self.rank)

    def reshape(self, mesh_shape: Tuple[int, int]) -> "Mesh":
        """The same devices (and owners), row-major, in another grid."""
        def grid(flat):
            if mesh_shape[0] * mesh_shape[1] != len(flat):
                raise ValueError(f"mesh {mesh_shape} != {len(flat)} devices")
            return tuple(tuple(flat[r * mesh_shape[1]:(r + 1) * mesh_shape[1]])
                         for r in range(mesh_shape[0]))

        owners = None if self.owners is None else grid([g.rank for g in self.global_devices()])
        return Mesh(grid(self.flat()), self.axis_names, owners, self.rank)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """torch.distributed for several processes (NCCL where there is a card,
    gloo on the CPU); a no-op for at most one process, as the JAX package's.
    coordinator_address is an init method such as tcp://localhost:29500. A
    caller that wants another backend (gloo for two ranks sharing one card)
    starts the group itself: make_mesh takes whatever group is running."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=coordinator_address,
        world_size=num_processes,
        rank=process_id,
    )


def group_size() -> int:
    """The processes of the running torch.distributed group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _default_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device (torch.cuda.is_available() is false); pass devices, "
            "e.g. [torch.device('cpu')] * 8, to run the mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def addressable(devices: Sequence) -> List[torch.device]:
    """devices as this process's torch.devices. A torch.device (or its
    name) is this process's own; a RankDevice of another rank raises
    ValueError: only the process owning a device can place data on it."""
    import torch.distributed as dist

    rank = dist.get_rank() if group_size() > 1 else 0
    out = []
    for d in devices:
        if isinstance(d, RankDevice):
            if d.rank != rank:
                raise ValueError(f"device {d.device} belongs to rank {d.rank}, not to this "
                                 f"process (rank {rank}): pass this process's own devices")
            d = d.device
        out.append(torch.device(d))
    return out


def make_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (rows, cols) mesh. devices default to every visible card,
    cuda:0 .. cuda:k-1 (no card: RuntimeError; it never falls back to the
    CPU); mesh_shape defaults to all of them on the rows axis. Devices may
    repeat (several shards on one device).

    Under a group of several processes, every rank calls it: devices are
    this rank's own (default its visible cards), and the mesh is every
    rank's devices in rank order, found by one all_gather_object."""
    devs = [torch.device(d) for d in devices] if devices is not None else _default_devices()
    owners, rank = None, 0
    world = group_size()
    if world > 1:
        import torch.distributed as dist

        rank = dist.get_rank()
        per_rank: List[Optional[List[str]]] = [None] * world
        dist.all_gather_object(per_rank, [str(d) for d in devs])
        devs = [torch.device(d) for names in per_rank for d in names]
        owners = [r for r, names in enumerate(per_rank) for _ in names]
    n = len(devs)
    if mesh_shape is None:
        mesh_shape = (n, 1)
    if mesh_shape[0] * mesh_shape[1] != n or n == 0:
        raise ValueError(f"mesh {mesh_shape} != {n} devices")
    flat = Mesh(tuple((d,) for d in devs), owners=None if owners is None else
                tuple((r,) for r in owners), rank=rank)
    return flat.reshape(tuple(mesh_shape))


def shard(t: torch.Tensor, mesh: Mesh, axis: str = ROWS,
          dim: int = 0) -> List[Optional[torch.Tensor]]:
    """t cut into mesh.shape[axis] equal pieces along dim, piece i copied
    onto the i-th device of the axis (the counterpart of a NamedSharding
    over that axis); None for another process's piece. The pieces own their
    memory, also where devices repeat."""
    d = mesh.shape[axis]
    if t.shape[dim] % d:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {d} shards")
    return [p.to(dev, copy=True).contiguous() if mine else None
            for p, dev, mine in zip(torch.chunk(t, d, dim=dim), mesh.axis_devices(axis),
                                    mesh.is_local(axis))]


def row_shards(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> List[Optional[torch.Tensor]]:
    """shard over the rows axis (jax's row_sharding)."""
    return shard(t, mesh, ROWS, dim)


def replicate(t: torch.Tensor, mesh: Mesh, axis: str = ROWS) -> List[Optional[torch.Tensor]]:
    """A copy of t on each device of the axis (jax's replicated); None on
    another process's."""
    return [t.to(dev, copy=True) if mine else None
            for dev, mine in zip(mesh.axis_devices(axis), mesh.is_local(axis))]
