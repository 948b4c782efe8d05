"""The collectives of the multi-device paths, over per-shard tensor lists.

What jax.lax.ppermute, psum, all_gather and axis_index do inside the JAX
package's shard_map bodies (parallel/sharded.py, routed_spmd.py), written for
one process: a sharded value is a list with one tensor per shard of a mesh
axis, shard i on mesh.axis_devices(axis)[i] (parallel/mesh.py).

Every exchange is a copy (Tensor.to(device, copy=True)): between two cards a
peer copy, which PyTorch orders after the source's and before the
destination's work on their current streams, so no host sync enters a
product; on one device a copy within it. A result never aliases its
source, also where shards share a device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .mesh import Mesh, ROWS


def axis_index(mesh: Mesh, axis: str = ROWS) -> List[int]:
    """jax.lax.axis_index per shard: 0 .. mesh.shape[axis] - 1."""
    return list(range(mesh.shape[axis]))


def _check(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.device]:
    devs = mesh.axis_devices(axis)
    if len(parts) != len(devs):
        raise ValueError(f"{len(parts)} shards for a mesh axis of {len(devs)}")
    return devs


def ppermute(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """jax.lax.ppermute: shard dst receives a copy of shard src for each
    (src, dst) of perm, on dst's device; a shard that receives nothing gets
    zeros."""
    devs = _check(parts, mesh, axis)
    out: List[torch.Tensor] = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(devs[dst], copy=True)
    return [o if o is not None else torch.zeros_like(p, device=d)
            for o, p, d in zip(out, parts, devs)]


def psum(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """jax.lax.psum: the sum of every shard's tensor, on every shard. The
    partials are added on the first shard's device in shard order (0, 1,
    ..., so a rerun is bitwise equal) and the sum copied to the others."""
    devs = _check(parts, mesh, axis)
    total = parts[0].to(devs[0], copy=True)
    for p in parts[1:]:
        total += p.to(devs[0])
    return [total] + [total.to(d, copy=True) for d in devs[1:]]


def all_gather(parts: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               dim: int = 0) -> List[torch.Tensor]:
    """jax.lax.all_gather(tiled=True): every shard's tensor joined along
    dim in shard order, on every shard."""
    devs = _check(parts, mesh, axis)
    return [torch.cat([p.to(d) for p in parts], dim=dim) for d in devs]


def gather_to(parts: Sequence[torch.Tensor], device, dim: int = 0) -> torch.Tensor:
    """The shards joined along dim on one device (a sharded output read as
    one global tensor)."""
    return torch.cat([p.to(device) for p in parts], dim=dim)
