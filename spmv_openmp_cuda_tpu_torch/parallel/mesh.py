"""Device mesh of the multi-device paths, in one process.

Counterpart of spmv_openmp_cuda_tpu/parallel/mesh.py. The JAX package is
single-controller: one process runs shard_map over a jax.sharding.Mesh, and
its tests run 8 virtual CPU devices. The port keeps that shape: one process,
a (rows, cols) grid of torch.devices with the axes

  "rows" — output-row data parallelism (the row-block OMP/CUDA analogs),
  "cols" — contraction-axis parallelism (the 2D-tiles partial-sum analog).

A device may appear more than once: n shards on one card are the counterpart
of JAX's virtual devices, and their exchanges are copies within the card. On
a host with several cards each shard has its own, and the exchanges are
peer copies (parallel/collectives.py). A mesh spanning processes is not
ported (ROADMAP.md queue 1, the cross-process mesh).

A sharded value is a list of tensors, one per distinct shard: row_shards and
replicate cut or copy a tensor onto the devices of a mesh axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ROWS = "rows"
COLS = "cols"

_CROSS_PROCESS = (
    "a mesh over the devices of several processes is not ported (ROADMAP.md queue 1, "
    "the cross-process mesh: NCCL send/recv and all-reduce)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (rows, cols) grid of torch.devices; devices may repeat."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (ROWS, COLS)

    @property
    def shape(self) -> dict:
        """{axis name: size}, as jax.sharding.Mesh.shape."""
        return {ROWS: len(self.devices), COLS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return self.shape[ROWS] * self.shape[COLS]

    def flat(self) -> List[torch.device]:
        """The devices in row-major order."""
        return [d for row in self.devices for d in row]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices of one line along `axis` (the first row or the first
        column): where the port computes the shards of a value sharded over
        that axis. The other axis holds replicas, which compute nothing the
        first does not."""
        if axis == ROWS:
            return [row[0] for row in self.devices]
        if axis == COLS:
            return list(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """torch.distributed for several processes (NCCL where there is a card,
    gloo on the CPU); a no-op for at most one process, as the JAX package's.
    coordinator_address is an init method such as tcp://localhost:29500."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=coordinator_address,
        world_size=num_processes,
        rank=process_id,
    )


def _default_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "make_mesh: no CUDA device (torch.cuda.is_available() is false); pass devices, "
            "e.g. [torch.device('cpu')] * 8, to run the mesh on the CPU"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    mesh_shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (rows, cols) mesh. devices default to every visible card,
    cuda:0 .. cuda:k-1 (no card: RuntimeError; it never falls back to the
    CPU); mesh_shape defaults to all of them on the rows axis. Devices may
    repeat (several shards on one device)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(_CROSS_PROCESS)
    devs = [torch.device(d) for d in devices] if devices is not None else _default_devices()
    n = len(devs)
    if mesh_shape is None:
        mesh_shape = (n, 1)
    if mesh_shape[0] * mesh_shape[1] != n or n == 0:
        raise ValueError(f"mesh {mesh_shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    grid = grid.reshape(mesh_shape)
    return Mesh(tuple(tuple(row) for row in grid))


def shard(t: torch.Tensor, mesh: Mesh, axis: str = ROWS, dim: int = 0) -> List[torch.Tensor]:
    """t cut into mesh.shape[axis] equal pieces along dim, piece i copied
    onto the i-th device of the axis (the counterpart of a NamedSharding
    over that axis). The pieces own their memory, also where devices
    repeat."""
    d = mesh.shape[axis]
    if t.shape[dim] % d:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {d} shards")
    return [p.to(dev, copy=True).contiguous()
            for p, dev in zip(torch.chunk(t, d, dim=dim), mesh.axis_devices(axis))]


def row_shards(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> List[torch.Tensor]:
    """shard over the rows axis (jax's row_sharding)."""
    return shard(t, mesh, ROWS, dim)


def replicate(t: torch.Tensor, mesh: Mesh, axis: str = ROWS) -> List[torch.Tensor]:
    """A copy of t on each device of the axis (jax's replicated)."""
    return [t.to(dev, copy=True) for dev in mesh.axis_devices(axis)]
