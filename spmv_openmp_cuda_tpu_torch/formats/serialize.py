"""Save and load prepared formats (checkpoint/resume).

Counterpart of spmv_openmp_cuda_tpu/formats/serialize.py, in the same .npz
layout, so that either package loads a file the other saved:

- `__meta__` holds JSON: `kind` (the JAX class name), `aux` (its static
  fields) and `bf16` (the indices of the leaves stored as uint16 bit
  patterns of bfloat16 values);
- `leaf{i}` are the arrays in the JAX pytree's leaf order for that kind (the
  data fields of its dataclass, None fields skipped), which this module
  keeps as tables of its own (`_LEAVES`, `_routed_leaves`);
- a DIA slab saved with its block plan carries `with_plan`; the plan is
  cheap and is derived again at load.

The port's operands are often a chain or a plan built on top of the
JAX-layout format (`RoutedChain`, `RoutedDFChain`, the DIA plan pair): save
writes the format, and load rebuilds the operands on the device asked for
(cuda unless the caller passes device="cpu") through the converters that
carry a JAX prepare across (`*_from_jax`, which validate what the kernels
index with) and build_chain / build_df_chain. Kinds the JAX package cannot write
raise TypeError here too: a chunked routed layout, a DIA+residual pair, the
tuples of the blocked torch modes.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from .binned import BinnedCSR
from .dia import DeviceDIA, DeviceDIADF
from .lanes import LanesSmall
from .matrix import DeviceCSR, DeviceELL, target_device
from .routed import RoutedCSR, RoutedDF
from .window import WindowCSR

#: leaf order of the JAX pytrees (their registered data fields)
_LEAVES = {
    "BinnedCSR": ("slab_data", "slab_cols", "out_pos"),
    "DeviceDIA": ("data",),
    "DeviceDIADF": ("data", "data_lo"),
    "DeviceELL": ("data", "cols", "row_lens"),
    "DeviceCSR": ("data", "cols", "row_ids", "indptr", "row_lens"),
    "LanesSmall": ("vals", "pidx", "gid"),
    "WindowCSR": ("vals", "sidx", "gid", "rsrc", "vals_lo"),
}
_PERM_LEAVES = ("r1", "w1", "w2", "w3", "r3", "wc")
#: the kinds, under the JAX classes' names (the port's classes carry them)
_KINDS = (BinnedCSR, DeviceDIA, DeviceDIADF, DeviceELL, DeviceCSR, LanesSmall, WindowCSR,
          RoutedCSR, RoutedDF)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def _unwrap(mat) -> Tuple[object, bool]:
    """(the format to write, with_plan): a chain's layout, a DIA pair's
    slab; TypeError for what the JAX package cannot write either."""
    from ..ops.routed_cuda import RoutedChain, RoutedDFChain

    if isinstance(mat, (RoutedChain, RoutedDFChain)):
        mat = mat.mat
    if isinstance(mat, tuple) and len(mat) == 2 and isinstance(mat[0], (DeviceDIA, DeviceDIADF)):
        return mat[0], True
    if type(mat) not in _KINDS:
        raise TypeError(type(mat))
    return mat, False


def _perm_aux(p) -> dict:
    return {"t": p.t, "has_r1": p.r1 is not None, "has_wc": p.wc is not None}


def _aux_of(mat) -> dict:
    """The JAX package's aux fields for each kind."""
    if isinstance(mat, BinnedCSR):
        return {
            "class_offsets": list(mat.class_offsets),
            "class_widths": [list(w) for w in mat.class_widths],
            "class_layouts": list(mat.class_layouts),
            "shape": list(mat.shape),
            "nnz": mat.nnz,
        }
    if isinstance(mat, (DeviceDIA, DeviceDIADF)):
        return {"offsets": list(mat.offsets), "shape": list(mat.shape), "nnz": mat.nnz,
                "pad_sub": mat.pad_sub}
    if isinstance(mat, DeviceELL):
        return {"shape": list(mat.shape), "nnz": mat.nnz, "max_row_nz": mat.max_row_nz,
                "transposed": mat.transposed}
    if isinstance(mat, DeviceCSR):
        return {"shape": list(mat.shape), "nnz": mat.nnz}
    if isinstance(mat, LanesSmall):
        return {"window_tiles": [list(wt) for wt in mat.window_tiles], "shape": list(mat.shape),
                "nnz": mat.nnz, "n_groups": mat.n_groups}
    if isinstance(mat, WindowCSR):
        return {
            "shape": list(mat.shape), "nnz": mat.nnz, "g": mat.g, "k_pad": mat.k_pad,
            "wr": mat.wr, "nspecs": mat.nspecs, "nblocks": mat.nblocks, "k_c": mat.k_c,
            "bps": mat.bps, "xdirect": mat.xdirect, "shared_w": mat.shared_w,
        }
    if isinstance(mat, RoutedCSR):
        return {
            "shape": list(mat.shape),
            "nnz": mat.nnz,
            "n_windows": mat.n_windows,
            "rows_a": mat.rows_a,
            "runs": [list(r) for r in mat.runs],
            "lvl_runs": [[list(r) for r in rs] for rs in mat.lvl_runs],
            "out_t": mat.out_t,
            "perm_products": _perm_aux(mat.perm_products),
            "lvl_perms": [_perm_aux(p) for p in mat.lvl_perms],
            "perm_out": _perm_aux(mat.perm_out),
            "n_lvl_masks": len(mat.lvl_masks),
            "has_heavy": mat.hvals is not None,
            "heavy_v2": mat.hlo is not None,
            "has_hdense": mat.hdense is not None,
            "heavy_rows": list(mat.heavy_rows),
            "widx_t": list(mat.widx_t),
            "heavy_lanes": list(mat.heavy_lanes),
        }
    if isinstance(mat, RoutedDF):
        return {"inner": _aux_of(mat.mat), "has_hdense_df": mat.hdense_hi is not None,
                "heavy_rows_df": list(mat.heavy_rows_df)}
    raise TypeError(type(mat))


def _routed_leaves(mat: RoutedCSR) -> List:
    leaves = [mat.vals, mat.pidx, mat.widx]
    for p in (mat.perm_products, *mat.lvl_perms):
        leaves += [getattr(p, f) for f in _PERM_LEAVES]
    leaves += list(mat.lvl_masks)
    leaves += [getattr(mat.perm_out, f) for f in _PERM_LEAVES]
    leaves += [mat.hvals, mat.hpidx, mat.hwidx, mat.hreduce, mat.hlo, mat.hhi, mat.hdense]
    return leaves


def _leaves(mat) -> List:
    if isinstance(mat, RoutedDF):
        leaves = _routed_leaves(mat.mat) + [mat.vals_lo, mat.hdense_hi, mat.hdense_lo]
    elif isinstance(mat, RoutedCSR):
        leaves = _routed_leaves(mat)
    else:
        leaves = [getattr(mat, f) for f in _LEAVES[type(mat).__name__]]
    return [a for a in leaves if a is not None]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.detach().cpu().view(torch.int16).numpy().view(np.uint16)
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_prepared(path: str, mat) -> None:
    """Write a prepared format (a mode's operands, or a layout) to path as
    .npz in the JAX package's layout; TypeError for a kind it cannot
    write."""
    mat, with_plan = _unwrap(mat)
    aux = _aux_of(mat)
    leaves = _leaves(mat)
    bf16 = [i for i, a in enumerate(leaves) if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16]
    if with_plan:
        aux["with_plan"] = True
    meta = {"kind": type(mat).__name__, "aux": aux, "bf16": bf16}
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f"leaf{i}": _host(a) for i, a in enumerate(leaves)},
    )


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


class _LeafReader:
    """The file's leaves in order: numpy arrays, bfloat16 ones as CPU
    tensors (numpy has no bfloat16)."""

    def __init__(self, z, bf16=()):
        self.z = z
        self.i = 0
        self.bf16 = set(bf16)

    def _one(self, k):
        a = self.z[f"leaf{k}"]
        if k in self.bf16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return a

    def take(self, n: int) -> list:
        out = [self._one(self.i + k) for k in range(n)]
        self.i += n
        return out


def _read_perm(r: _LeafReader, aux: dict) -> Dict:
    # files older than wc carry no has_wc (False); older ones still may
    # carry a trailing w2s leaf (a staging index since removed), read and
    # dropped, as the JAX package does
    has_wc, has_w2s = aux.get("has_wc", False), aux.get("has_w2s", False)
    leaves = r.take(4 + bool(aux["has_r1"]) + bool(has_wc) + bool(has_w2s))
    r1 = leaves.pop(0) if aux["has_r1"] else None
    if has_w2s:
        leaves.pop()
    wc = leaves.pop() if has_wc else None
    w1, w2, w3, r3 = leaves
    return dict(r1=r1, w1=w1, w2=w2, w3=w3, r3=r3, wc=wc, t=aux["t"])


def _read_routed(r: _LeafReader, aux: dict) -> dict:
    """routed_from_jax's keyword set (without the device)."""
    vals, pidx, widx = r.take(3)
    kw = dict(
        vals=vals, pidx=pidx, widx=widx,
        perm_products=_read_perm(r, aux["perm_products"]),
        lvl_perms=[_read_perm(r, pa) for pa in aux["lvl_perms"]],
        lvl_masks=r.take(aux["n_lvl_masks"]),
        perm_out=_read_perm(r, aux["perm_out"]),
    )
    # files older than the heavy paths carry none of their keys
    if aux.get("has_heavy"):
        kw.update(zip(("hvals", "hpidx", "hwidx", "hreduce"), r.take(4)))
        if aux.get("heavy_v2"):
            kw.update(zip(("hlo", "hhi"), r.take(2)))
    if aux.get("has_hdense"):
        (kw["hdense"],) = r.take(1)
    kw.update(
        shape=aux["shape"], nnz=aux["nnz"], n_windows=aux["n_windows"], rows_a=aux["rows_a"],
        runs=aux["runs"], lvl_runs=aux["lvl_runs"], out_t=aux["out_t"],
        heavy_rows=aux.get("heavy_rows", []), widx_t=aux.get("widx_t", []),
        heavy_lanes=aux.get("heavy_lanes", []),
    )
    return kw


def _load_dia(r: _LeafReader, kind: str, aux: dict, n_leaves: int, device):
    """A DeviceDIA[DF]; with its plan, the (slab padded to the plan, plan)
    pair of the PL_DIA modes (validated by from_jax_operands), the plan
    derived from the saved slab as the JAX package does."""
    from ..ops.spmv_cuda import DF_DIA_VMEM_BUDGET, _to_tensor, from_jax_operands, plan_dia
    from .dia import make_device_dia, make_device_dia_df

    planes = [_to_tensor(a, "cpu") for a in r.take(n_leaves)]
    # files saved before the pad -> pad_sub rename hold the element count
    pad_sub = aux.get("pad_sub", -(-aux.get("pad", 0) // 128))
    args = (aux["offsets"], aux["shape"], aux["nnz"], pad_sub)
    if not aux.get("with_plan"):
        if kind == "DeviceDIADF":
            return make_device_dia_df(*(p.to(device) for p in planes), *args)
        return make_device_dia(planes[0].to(device), *args)
    hi = make_device_dia(planes[0], *args)
    plan = plan_dia(hi, vmem_budget=DF_DIA_VMEM_BUDGET) if kind == "DeviceDIADF" else plan_dia(hi)
    pad = plan.s_pad - planes[0].shape[1]
    planes = [torch.nn.functional.pad(p, (0, 0, 0, pad)) for p in planes]
    mat, plan, _ = from_jax_operands(
        planes[0], *args, bs=plan.bs, nblocks=plan.nblocks, s_pad=plan.s_pad,
        data_lo=planes[1] if kind == "DeviceDIADF" else None, device=device,
    )
    return mat, plan


def load_prepared(path: str, device="cuda"):
    """Read a file that either package saved and rebuild the port's
    operands on `device`: a RoutedChain (RoutedCSR), a RoutedDFChain
    (RoutedDF), the (slab, plan) pair of a DIA file saved with its plan,
    else the format itself."""
    from ..ops.ell_cuda import ell_from_jax
    from ..ops.lanes_cuda import lanes_from_jax
    from ..ops.routed_cuda import build_chain, build_df_chain, routed_df_from_jax, routed_from_jax
    from ..ops.spmv_cuda import _to_tensor
    from ..ops.window_cuda import window_from_jax

    device = target_device(device)
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    kind, aux = meta["kind"], meta["aux"]
    r = _LeafReader(z, bf16=meta.get("bf16", ()))
    n_leaves = len(z.files) - 1
    shape = tuple(aux.get("shape", ()))
    if kind == "BinnedCSR":
        slab_data, slab_cols, out_pos = (_to_tensor(a, device) for a in r.take(3))
        return BinnedCSR(
            slab_data=slab_data, slab_cols=slab_cols, out_pos=out_pos,
            class_offsets=tuple(aux["class_offsets"]),
            class_widths=tuple(tuple(w) for w in aux["class_widths"]),
            class_layouts=tuple(aux["class_layouts"]), shape=shape, nnz=aux["nnz"],
        )
    if kind in ("DeviceDIA", "DeviceDIADF"):
        return _load_dia(r, kind, aux, n_leaves, device)
    if kind == "DeviceELL":
        data, cols, row_lens = r.take(3)
        return ell_from_jax(data, cols, row_lens, shape, aux["nnz"], aux["max_row_nz"],
                            aux["transposed"], device=device)
    if kind == "DeviceCSR":
        data, cols, row_ids, indptr, row_lens = (_to_tensor(a, device) for a in r.take(5))
        return DeviceCSR(data=data, cols=cols, row_ids=row_ids, indptr=indptr, row_lens=row_lens,
                         shape=shape, nnz=aux["nnz"])
    if kind == "LanesSmall":
        vals, pidx, gid = r.take(3)
        return lanes_from_jax(vals, pidx, gid, aux["window_tiles"], shape, aux["nnz"],
                              aux["n_groups"], device=device)
    if kind == "WindowCSR":
        leaves = r.take(n_leaves)
        # older files: k_c 0 (global packing), one block per step, no
        # direct x, a Q map per sub-block
        late = dict(k_c=0, bps=1, xdirect=False, shared_w=False)
        return window_from_jax(*leaves[:4], shape, aux["nnz"],
                               *(aux[k] for k in ("g", "k_pad", "wr", "nspecs", "nblocks")),
                               *(aux.get(k, v) for k, v in late.items()),
                               vals_lo=leaves[4] if len(leaves) > 4 else None, device=device)
    if kind == "RoutedCSR":
        return build_chain(routed_from_jax(**_read_routed(r, aux), device=device))
    if kind == "RoutedDF":
        inner = _read_routed(r, aux["inner"])
        (vals_lo,) = r.take(1)
        hh = hl = None
        if aux.get("has_hdense_df"):
            hh, hl = r.take(2)
        return build_df_chain(routed_df_from_jax(inner, vals_lo, hh, hl,
                                                 aux.get("heavy_rows_df", []), device=device))
    raise ValueError(f"unknown kind {kind}")
