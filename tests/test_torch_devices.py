"""Where the port's tensors go when the caller names no device.

Every prepare, planner and converter of spmv_openmp_cuda_tpu_torch places
its tensors on the card unless the caller passes device="cpu", and resolves
that device (formats/matrix.py::target_device) before any host work: without
a card the default raises RuntimeError at once and never falls back to the
CPU. Here, on the CPU, torch.cuda.is_available is patched to False for the
default; device="cpu" must give tensors on the CPU. A guard walks the
package's sources so that no public function gains a CPU default again.
"""
import ast
import dataclasses
import inspect
import pathlib

import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import contract
from spmv_openmp_cuda_tpu_torch.bench import harness, scaling, sweep
from spmv_openmp_cuda_tpu_torch.config import LANE, Config
from spmv_openmp_cuda_tpu_torch.formats import binned, dia, lanes, matrix, routed, serialize, window
from spmv_openmp_cuda_tpu_torch.models import solvers
from spmv_openmp_cuda_tpu_torch.models.auto import AutoSpMV
from spmv_openmp_cuda_tpu_torch.ops import ell_cuda, lanes_cuda, registry, route, routed_cuda
from spmv_openmp_cuda_tpu_torch.ops import spmv_cuda, window_cuda
from spmv_openmp_cuda_tpu_torch.parallel import mesh, sharded
from spmv_openmp_cuda_tpu_torch.utils import synth

_PKG = pathlib.Path(T.__file__).resolve().parent

_CSR = T.coo_to_csr(synth.banded(1024, 1024, 8, fill=0.9, seed=3))
_CPU = {"device": "cpu"}


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _perm(t: int) -> np.ndarray:
    return np.random.default_rng(t).permutation(t * LANE * LANE)


# ---- converter inputs: the port's own CPU layouts as plain arrays ----------


def _ell_args():
    e = matrix.device_ell(T.coo_to_ell(synth.banded(1024, 1024, 8, fill=0.9, seed=3)),
                          transposed=True, device="cpu")
    return (e.data.numpy(), e.cols.numpy(), e.row_lens.numpy(), e.shape, e.nnz, e.max_row_nz,
            e.transposed), {}


def _lanes_args():
    m = lanes.prepare_lanes_small(_CSR, device="cpu")
    return (m.vals.numpy(), m.pidx.numpy(), m.gid.numpy(), m.window_tiles, m.shape, m.nnz,
            m.n_groups), {}


def _routed_args():
    return (), _fields(routed.prepare_routed(_CSR, device="cpu"))


def _chunks_args():
    c = routed.prepare_routed_chunked(_CSR, chunk_nnz=6000, fit_domains=False, device="cpu")
    return ([_fields(m) for m in c.chunks], c.bounds, c.shape, c.nnz), {}


def _df_args():
    d = routed.prepare_routed_df(_CSR, device="cpu")
    return (_fields(d.mat), d.vals_lo.numpy(), d.hdense_hi, d.hdense_lo,
            d.heavy_rows_df), {}


def _dia_args():
    dr, plan = spmv_cuda.prepare_dia_resid(_CSR, device="cpu")
    m = dr.mat
    return (m.data.numpy(), m.offsets, m.shape, m.nnz, m.pad_sub, plan.bs, plan.nblocks,
            plan.s_pad), {}


def _window_args():
    w = window.prepare_window_auto(_CSR, device="cpu")
    keys = ("vals", "sidx", "gid", "rsrc", "shape", "nnz", "g", "k_pad", "wr", "nspecs",
            "nblocks", "k_c", "bps", "xdirect", "shared_w", "vals_lo")
    return (), {k: getattr(w, k) for k in keys}


def _plain(*args, **kwargs):
    return lambda: (args, kwargs)


#: name -> (function, its arguments but device: () -> (args, kwargs))
PREPARES = {
    # the 19 that defaulted to the CPU
    "prepare_binned_csr": (binned.prepare_binned_csr, _plain(_CSR)),
    "prepare_dia_df": (dia.prepare_dia_df, _plain(_CSR)),
    "device_csr": (matrix.device_csr, _plain(_CSR)),
    "device_ell": (matrix.device_ell, _plain(T.coo_to_ell(synth.banded(256, 256, 4, seed=1)))),
    "prepare_routed": (routed.prepare_routed, _plain(_CSR)),
    "prepare_routed_chunked": (routed.prepare_routed_chunked, _plain(_CSR)),
    "prepare_window": (window.prepare_window, _plain(_CSR, g=8)),
    "prepare_window_auto": (window.prepare_window_auto, _plain(_CSR)),
    "prepare_dia_df_pallas": (spmv_cuda.prepare_dia_df_pallas, _plain(_CSR)),
    "prepare_dia_resid": (spmv_cuda.prepare_dia_resid, _plain(_CSR)),
    "plan_permutation": (route.plan_permutation, _plain(_perm(1), 1)),
    "plan_row_to_slot": (route.plan_row_to_slot,
                         _plain(np.repeat(np.arange(2 * LANE), LANE), _perm(2), 2)),
    "ell_from_jax": (ell_cuda.ell_from_jax, _ell_args),
    "lanes_from_jax": (lanes_cuda.lanes_from_jax, _lanes_args),
    "routed_from_jax": (routed_cuda.routed_from_jax, _routed_args),
    "routed_chunks_from_jax": (routed_cuda.routed_chunks_from_jax, _chunks_args),
    "routed_df_from_jax": (routed_cuda.routed_df_from_jax, _df_args),
    "from_jax_operands": (spmv_cuda.from_jax_operands, _dia_args),
    "window_from_jax": (window_cuda.window_from_jax, _window_args),
    # the seven already on the card by default
    "prepare_dia": (dia.prepare_dia, _plain(_CSR)),
    "prepare_lanes_small": (lanes.prepare_lanes_small, _plain(_CSR)),
    "prepare_routed_auto": (routed.prepare_routed_auto, _plain(_CSR)),
    "prepare_routed_chain": (routed_cuda.prepare_routed_chain, _plain(_CSR)),
    "prepare_routed_df_chain": (routed_cuda.prepare_routed_df_chain, _plain(_CSR)),
    "prepare_routed_df": (routed.prepare_routed_df, _plain(_CSR)),
    "prepare_routed_df_auto": (routed.prepare_routed_df_auto, _plain(_CSR)),
}


def _tensors(obj, seen=None):
    """Every tensor reachable from obj through dataclasses, sequences and
    dicts."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", list(PREPARES))
def test_prepares_default_to_the_card(no_card, name):
    """The default device is the card: without one the call raises, and
    device="cpu" gives every tensor of the result on the CPU."""
    fn, make = PREPARES[name]
    args, kwargs = make()
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        fn(*args, **kwargs)
    out = fn(*args, **kwargs, **_CPU)
    found = list(_tensors(out))
    assert found, name
    assert all(t.device.type == "cpu" for t in found), name


@pytest.mark.parametrize("name", list(PREPARES))
def test_the_card_check_comes_before_host_work(no_card, name):
    """With every input None, the card check is what raises: it runs before
    the function reads its inputs."""
    fn, _ = PREPARES[name]
    required = [p for p in inspect.signature(fn).parameters.values()
                if p.default is inspect.Parameter.empty]
    with pytest.raises(RuntimeError, match="is_available"):
        fn(**{p.name: None for p in required})


#: the entry points whose default (None or "cuda") resolves to the card
ENTRY_POINTS = {
    "AutoSpMV.from_csr": lambda: AutoSpMV.from_csr(_CSR),
    "load_prepared": lambda: serialize.load_prepared("no-such-file.npz"),
    "conjugate_gradient": lambda: solvers.conjugate_gradient(lambda v: v, np.ones(8)),
    "power_iteration": lambda: solvers.power_iteration(lambda v: v, 8, iters=2),
    "run_kernel": lambda: harness.run_kernel(registry.get("CSR_ROWS"), _CSR, None,
                                             np.ones(1024), Config()),
    "run_all": lambda: harness.run_all(_CSR, None, np.ones(1024), Config()),
    "sweep": lambda: sweep.sweep(["no-such-matrix.mtx"]),
    "contract.entry": lambda: contract.entry(),
    "contract.mesh_devices": lambda: contract.mesh_devices(2),
    "contract.dryrun_multichip": lambda: contract.dryrun_multichip(2),
    "make_mesh": lambda: mesh.make_mesh(),
    "prepare_routed_multidevice": lambda: sharded.prepare_routed_multidevice(_CSR),
    "scaling.measure": lambda: scaling.measure("cavity10_like", [1], "dia_halo"),
    "scaling.run_scaling": lambda: scaling.run_scaling("cavity10_like", [1], "dia_halo"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(no_card, name):
    """Given no device, each entry point asks for the card and, without one,
    raises instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="is_available"):
        ENTRY_POINTS[name]()


def _device_params():
    """(file:line function, parameter, default source or None) for every
    device/devices parameter of every function of the package."""
    for path in sorted(_PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
            for arg, default in list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults)):
                if arg.arg in ("device", "devices"):
                    where = f"{path.relative_to(_PKG)}:{node.lineno} {node.name}"
                    yield where, node.name, default


def test_no_public_function_defaults_to_the_cpu():
    """A public function's device default is "cuda", or None where None
    resolves to the card (contract.py, parallel/mesh.py); the private
    helpers that take a device have no default, so a caller that forgets to
    pass it fails loudly."""
    found = list(_device_params())
    assert len(found) > 40
    bad = [where for where, name, d in found if not name.startswith("_") and d is not None
           and not (isinstance(d, ast.Constant) and d.value in ("cuda", None))]
    assert not bad, bad
    private = {name: d for _w, name, d in found
               if name in ("_prepare_routed_placed", "_try_prepare_auto", "_stages_from_routing")}
    assert set(private) == {"_prepare_routed_placed", "_try_prepare_auto",
                            "_stages_from_routing"}
    assert all(d is None for d in private.values()), private
