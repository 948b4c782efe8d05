"""The collectives of the multi-device paths, over per-shard tensor lists.

What jax.lax.ppermute, psum, all_gather and axis_index do inside the JAX
package's shard_map bodies (parallel/sharded.py, routed_spmd.py): a sharded
value is a list with one entry per shard of a mesh axis, shard i on
mesh.axis_devices(axis)[i] (parallel/mesh.py), None where another process
owns it.

In one process every exchange is a copy (Tensor.to(device, copy=True)):
between two cards a peer copy, which PyTorch orders after the source's and
before the destination's work on their current streams, so no host sync
enters a product; on one device a copy within it. A result never aliases
its source, also where shards share a device.

Across processes (a mesh built under a torch.distributed group) the pairs
that cross processes go through torch.distributed: ppermute by one
batch_isend_irecv per call, psum, all_gather and gather_to by an all-gather
of every shard's tensor, summed or joined in shard order on every rank (no
all_reduce, whose order the backend picks: the bits equal the one-process
ones). Every rank issues the same collectives in the same order, also a rank
that owns no shard of the axis. _wire says where the exchanged tensors lie.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, ROWS

Parts = List[Optional[torch.Tensor]]


def axis_index(mesh: Mesh, axis: str = ROWS) -> List[int]:
    """jax.lax.axis_index per shard: 0 .. mesh.shape[axis] - 1."""
    return list(range(mesh.shape[axis]))


def each(fn, *parts) -> Parts:
    """fn over the shards this process owns (where the first list's entry
    is not None), None in the others' places."""
    return [None if a[0] is None else fn(*a) for a in zip(*parts)]


def _check(parts: Sequence[Optional[torch.Tensor]], mesh: Mesh, axis: str) -> List[torch.device]:
    devs = mesh.axis_devices(axis)
    if len(parts) != len(devs):
        raise ValueError(f"{len(parts)} shards for a mesh axis of {len(devs)}")
    if [p is not None for p in parts] != mesh.is_local(axis):
        raise ValueError("a shard list must hold exactly this process's shards of the axis")
    return devs


def _wire() -> torch.device:
    """Where a tensor must lie for the group's backend to move it. gloo
    moves CPU tensors only (send/recv and all_gather alike): a shard on the
    card is copied to the host before the exchange and back after it. NCCL
    moves CUDA tensors, on this rank's current card: they stay there."""
    backend = dist.get_backend()
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"collectives: backend {backend!r} is neither gloo nor nccl")


def ppermute(parts: Parts, mesh: Mesh, axis: str, perm: Sequence[Tuple[int, int]]) -> Parts:
    """jax.lax.ppermute: shard dst receives a copy of shard src for each
    (src, dst) of perm, on dst's device; a shard that receives nothing gets
    zeros. Across processes the crossing pairs are one batch_isend_irecv
    (sent and received in perm's order on both sides, tagged by dst)."""
    devs = _check(parts, mesh, axis)
    out: Parts = [None] * len(parts)
    owner, me = mesh.axis_owners(axis), mesh.rank
    ops, received = [], []
    for src, dst in perm:
        if owner[src] == me and owner[dst] == me:
            out[dst] = parts[src].to(devs[dst], copy=True)
        elif owner[src] == me:
            ops.append(dist.P2POp(dist.isend, parts[src].to(_wire()).contiguous(), owner[dst],
                                  tag=dst))
        elif owner[dst] == me:
            buf = torch.empty(parts[dst].shape, dtype=parts[dst].dtype, device=_wire())
            ops.append(dist.P2POp(dist.irecv, buf, owner[src], tag=dst))
            received.append((dst, buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for dst, buf in received:
        out[dst] = buf.to(devs[dst])
    return [o if o is not None or p is None else torch.zeros_like(p, device=d)
            for o, p, d in zip(out, parts, devs)]


_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16, torch.int32,
           torch.int64, torch.int8, torch.uint8, torch.bool)
_MAX_DIM = 4


def _every_shard(parts: Parts, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Every shard's tensor of the axis, in this process: its own as they
    are, the others' as the group delivered them (on _wire()). Two
    all-gathers: each shard's dtype and shape, then the bytes of each rank's
    shards, padded to the longest rank's."""
    devs = _check(parts, mesh, axis)
    if not mesh.spans_processes:
        return list(parts)
    wire, world = _wire(), dist.get_world_size()
    meta = torch.zeros((len(parts), 2 + _MAX_DIM), dtype=torch.int64)
    for i, p in enumerate(parts):
        if p is not None:
            if p.dim() > _MAX_DIM:
                raise ValueError(f"collectives: {p.dim()}-d shard, at most {_MAX_DIM}")
            meta[i, :2 + p.dim()] = torch.tensor([_DTYPES.index(p.dtype), p.dim(), *p.shape])
    metas = [torch.empty_like(meta, device=wire) for _ in range(world)]
    dist.all_gather(metas, meta.to(wire))
    owner = mesh.axis_owners(axis)
    shapes = []
    for i in range(len(devs)):
        row = metas[owner[i]][i].tolist()
        shapes.append((_DTYPES[row[0]], tuple(row[2:2 + row[1]])))

    def nbytes(dtype, shape):
        return torch.empty((), dtype=dtype).element_size() * math.prod(shape)

    sizes = [sum(nbytes(*shapes[i]) for i in range(len(devs)) if owner[i] == r)
             for r in range(world)]
    mine = [p.contiguous().reshape(-1).view(torch.uint8).to(wire) for p in parts if p is not None]
    payload = torch.zeros(max(sizes), dtype=torch.uint8, device=wire)
    if mine:
        flat = torch.cat(mine)
        payload[: flat.numel()] = flat
    got = [torch.empty_like(payload) for _ in range(world)]
    dist.all_gather(got, payload)
    out, at = [], [0] * world
    for i, (dtype, shape) in enumerate(shapes):
        r, k = owner[i], nbytes(dtype, shape)
        if parts[i] is not None:
            out.append(parts[i])
        else:
            out.append(got[r][at[r]: at[r] + k].clone().view(dtype).reshape(shape))
        at[r] += k
    return out


def sum_to(parts: Parts, mesh: Mesh, axis: str, device) -> torch.Tensor:
    """The sum of every shard's tensor on one device of this process, added
    in shard order (0, 1, ...: a rerun and every rank give the same bits)."""
    every = _every_shard(parts, mesh, axis)
    total = every[0].to(device, copy=True)
    for p in every[1:]:
        total += p.to(device)
    return total


def psum(parts: Parts, mesh: Mesh, axis: str) -> Parts:
    """jax.lax.psum: the sum of every shard's tensor, on every own shard.
    The partials are added on the axis' home device (mesh.home) in shard
    order and the sum copied to the other shards."""
    devs = _check(parts, mesh, axis)
    home = mesh.home(axis)
    total = sum_to(parts, mesh, axis, home)
    out: Parts = [None] * len(parts)
    for i, (d, p) in enumerate(zip(devs, parts)):
        if p is not None:  # the first own shard (on home) takes the sum itself
            out[i] = total if all(o is None for o in out) else total.to(d, copy=True)
    return out


def all_gather(parts: Parts, mesh: Mesh, axis: str, dim: int = 0) -> Parts:
    """jax.lax.all_gather(tiled=True): every shard's tensor joined along
    dim in shard order, on every own shard."""
    devs = _check(parts, mesh, axis)
    every = _every_shard(parts, mesh, axis)
    return [torch.cat([p.to(d) for p in every], dim=dim) if own is not None else None
            for own, d in zip(parts, devs)]


def gather_to(parts: Parts, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The shards joined along dim on the axis' home device (a sharded
    output read as one global tensor); under a process group every rank
    gets it."""
    home = mesh.home(axis)
    return torch.cat([p.to(home) for p in _every_shard(parts, mesh, axis)], dim=dim)
