"""Prepared-format files between the port and the JAX package
(formats/serialize.py): every kind the JAX package writes, through both
registries' prepares on the same matrix.

- JAX save -> port load: every array equal to the port's own prepare (bf16
  bit for bit), and y torch.equal to the port-prepared operands' y;
- port save -> JAX load: every leaf equal to the JAX prepare's, and the
  JAX y of the loaded operands equal to the JAX y of the prepared ones;
- the kinds the JAX package cannot write (a chunked routed layout, a
  DIA+residual pair) raise TypeError in both packages.

The port's prepares run their numpy paths (torch_numpy_path): the layouts are
held array for array against the JAX package's numpy prepares.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.formats import routed as jr
from spmv_openmp_cuda_tpu.formats import serialize as jser
from spmv_openmp_cuda_tpu.ops import registry as jreg
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch.config import Config
from spmv_openmp_cuda_tpu_torch.formats import routed as tr
from spmv_openmp_cuda_tpu_torch.formats import serialize as tser
from spmv_openmp_cuda_tpu_torch.ops import registry as treg
from spmv_openmp_cuda_tpu_torch.ops import routed_cuda as trc
from spmv_openmp_cuda_tpu_torch.utils import synth
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


def _spiked(m, n, n_heavy, per_heavy, seed):
    """A few dense heavy rows over a sparse background: the routed layout
    keeps them in the dense heavy block (hdense; f64: hdense_hi/lo)."""
    rng = np.random.default_rng(seed)
    coo = synth.random_uniform(m, n, density=3.0 / n, seed=seed)
    rows = [coo.rows]
    cols = [coo.cols]
    for h in range(n_heavy):
        c = rng.choice(n, per_heavy, replace=False)
        rows.append(np.full(per_heavy, h * (m // n_heavy)))
        cols.append(c)
    r, c = np.concatenate(rows), np.concatenate(cols)
    key = np.unique(r * n + c)
    return T.COOMatrix((m, n), key // n, key % n, rng.standard_normal(key.size))


CASES = {
    "power_law": lambda: synth.power_law(400, 400, 5.0, seed=1),
    "banded": lambda: synth.banded(600, 600, 4, seed=3),
    "fem": lambda: synth.fem_like(m=2000, n=2000, nnz=20000, spread=300, lo=4, hi=14, seed=6),
    "lanes": lambda: synth.random_uniform(600, 600, 0.01, seed=3),
    "spiked": lambda: _spiked(3000, 20000, 3, 4000, 9),
}

#: (mode, case, dtype): every kind the JAX package writes
RUNS = [
    ("CSR_ROWS_BINNED", "power_law", "float32"),
    ("DIA_ROWS", "banded", "float32"),
    ("PL_DIA_ROWS", "banded", "float32"),
    ("PL_DIA_BF16", "banded", "float32"),
    ("PL_DIA_F64", "banded", "float64"),
    ("ELL_ROWS", "power_law", "float32"),
    ("ELL_ROWS_T", "power_law", "float32"),
    ("CSR_ROWS", "power_law", "float32"),
    ("PL_CSR_LANES", "lanes", "float32"),
    ("PL_CSR_WINDOW", "fem", "float32"),
    ("PL_CSR_WINDOW_BF16", "fem", "float32"),
    ("PL_CSR_WINDOW_F64", "fem", "float64"),
    ("PL_CSR_ROUTED", "power_law", "float32"),
    ("PL_CSR_ROUTED_BF16", "spiked", "float32"),
    ("PL_CSR_ROUTED", "spiked", "float32"),
    ("PL_CSR_ROUTED_F64", "spiked", "float64"),
]


def _both(case):
    coo = CASES[case]()
    r, c, v = (np.asarray(a) for a in (coo.rows, coo.cols, coo.vals))
    out = []
    for pkg in (T, J):
        pc = pkg.COOMatrix(coo.shape, r.astype(np.int64), c.astype(np.int64), v.astype(np.float64))
        out.append((pkg.coo_to_csr(pc), pkg.coo_to_ell(pc)))
    return out


def _jprepare(mode, jcsr, jell, dtype):
    js = jreg.get(mode)
    with jax.enable_x64(dtype == "float64"):
        return js.prepare(jcsr, jell, J.Config(dtype=dtype))


def _jrun(mode, ops, x, dtype):
    js = jreg.get(mode)
    with jax.enable_x64(dtype == "float64"):
        return np.asarray(js.jitted(ops)(jnp.asarray(x, jnp.float64 if dtype == "float64" else
                                                      jnp.float32)))


def _trun(mode, ops, x, dtype):
    spec = treg.get(mode)
    xt = torch.as_tensor(x, dtype=torch.float64 if spec.f64 or dtype == "float64" else torch.float32)
    return spec.jitted(ops)(xt)


def _leaf_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_format(ops):
    """The JAX-layout format inside the port's operands."""
    if isinstance(ops, (trc.RoutedChain, trc.RoutedDFChain)):
        return ops.mat
    return ops[0] if isinstance(ops, tuple) else ops


def _port_leaves(ops):
    fmt = _port_format(ops)
    return [_leaf_bits(a) for a in tser._leaves(fmt)]


def _jax_leaves(ops):
    fmt = ops[0] if isinstance(ops, tuple) else ops
    return [_leaf_bits(a) for a in jax.tree_util.tree_leaves(fmt)]


def _assert_leaves_equal(a, b):
    assert len(a) == len(b)
    for i, (u, v) in enumerate(zip(a, b)):
        assert u.dtype == v.dtype and u.shape == v.shape, (i, u.dtype, v.dtype, u.shape, v.shape)
        np.testing.assert_array_equal(u, v, err_msg=f"leaf {i}")


@pytest.mark.parametrize("mode,case,dtype", RUNS)
def test_jax_save_port_load(tmp_path, mode, case, dtype):
    (tcsr, tell), (jcsr, jell) = _both(case)
    path = str(tmp_path / "m.npz")
    jser.save_prepared(path, _jprepare(mode, jcsr, jell, dtype))
    loaded = tser.load_prepared(path, device="cpu")
    ops = treg.get(mode).prepare(tcsr, tell, Config(dtype=dtype), torch.device("cpu"))
    assert type(_port_format(loaded)) is type(_port_format(ops))
    _assert_leaves_equal(_port_leaves(loaded), _port_leaves(ops))
    if isinstance(ops, tuple):
        assert loaded[1] == ops[1]  # the DIA plan
    x = np.random.default_rng(1).standard_normal(tcsr.shape[1])
    assert torch.equal(_trun(mode, loaded, x, dtype), _trun(mode, ops, x, dtype))


@pytest.mark.parametrize("mode,case,dtype", RUNS)
def test_port_save_jax_load(tmp_path, mode, case, dtype):
    (tcsr, tell), (jcsr, jell) = _both(case)
    path = str(tmp_path / "m.npz")
    tser.save_prepared(path, treg.get(mode).prepare(tcsr, tell, Config(dtype=dtype),
                                                    torch.device("cpu")))
    with jax.enable_x64(dtype == "float64"):
        loaded = jser.load_prepared(path)
    jops = _jprepare(mode, jcsr, jell, dtype)
    _assert_leaves_equal(_jax_leaves(loaded), _jax_leaves(jops))
    x = np.random.default_rng(2).standard_normal(tcsr.shape[1])
    np.testing.assert_array_equal(_jrun(mode, loaded, x, dtype), _jrun(mode, jops, x, dtype))


def test_pooled_heavy_tiles_round_trip(tmp_path, monkeypatch):
    """A layout with pooled heavy tiles (hvals, hpidx, hwidx, hreduce, hlo,
    hhi: ten rows of 5000 columns, pooled as SPMV_DENSE_HEAVY=0 makes the
    JAX package do) crosses both ways."""
    rng = np.random.default_rng(11)
    m, n = 2000, 40000
    rows = [np.full(5000, r) for r in range(10)] + [rng.integers(10, m, 8000)]
    cols = [rng.choice(n, 5000, replace=False) for _ in range(10)] + [rng.integers(0, n, 8000)]
    rows, cols = np.unique(np.stack([np.concatenate(rows), np.concatenate(cols)]), axis=1)
    tcsr = T.coo_to_csr(T.COOMatrix((m, n), rows, cols, rng.standard_normal(rows.shape[0])))
    jcsr = J.CSRMatrix(shape=tcsr.shape, indptr=tcsr.indptr, indices=tcsr.indices, data=tcsr.data)
    monkeypatch.setenv("SPMV_DENSE_HEAVY", "0")
    monkeypatch.setattr(tr, "_dense_heavy_ok", lambda *a: False)
    tchain = trc.build_chain(tr.prepare_routed(tcsr, heavy_threshold=4096, device="cpu"))
    jmat = jr.prepare_routed(jcsr, heavy_threshold=4096)
    assert jmat.hvals is not None and tchain.mat.hvals is not None
    p_j, p_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_prepared(p_j, jmat)
    tser.save_prepared(p_t, tchain)
    loaded_t = tser.load_prepared(p_j, device="cpu")
    _assert_leaves_equal(_port_leaves(loaded_t), _port_leaves(tchain))
    _assert_leaves_equal(_jax_leaves(jser.load_prepared(p_t)), _jax_leaves(jmat))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(n), dtype=torch.float32)
    assert torch.equal(trc.routed_chain_spmv(loaded_t, x), trc.routed_chain_spmv(tchain, x))


def test_unwritable_kinds_raise_type_error(tmp_path):
    """What the JAX package cannot write raises TypeError in the port too."""
    (tcsr, tell), (jcsr, jell) = _both("banded")
    cfg = Config()
    for mode in ("PL_DIA_RESID", "CSR_TILES"):
        with pytest.raises(TypeError):
            jser.save_prepared(str(tmp_path / "j.npz"), jreg.get(mode).prepare(jcsr, jell, J.Config()))
        with pytest.raises(TypeError):
            tser.save_prepared(str(tmp_path / "t.npz"),
                               treg.get(mode).prepare(tcsr, tell, cfg, torch.device("cpu")))
    chunks = tr.prepare_routed_chunked(tcsr, chunk_nnz=600, fit_domains=False, device="cpu")
    assert len(chunks.chunks) > 1
    with pytest.raises(TypeError):
        tser.save_prepared(str(tmp_path / "c.npz"), trc.build_chain(chunks))
    with pytest.raises(TypeError):
        tser.save_prepared(str(tmp_path / "c.npz"), chunks)


def test_load_defaults_to_the_card(tmp_path):
    """load_prepared builds on cuda unless asked for the CPU: without a
    card, that default raises (as AutoSpMV.from_csr does)."""
    (tcsr, tell), _ = _both("power_law")
    path = str(tmp_path / "m.npz")
    tser.save_prepared(path, treg.get("CSR_ROWS").prepare(tcsr, tell, Config(), torch.device("cpu")))
    if torch.cuda.is_available():
        assert tser.load_prepared(path).data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tser.load_prepared(path)


#: aux keys the JAX loader defaults for files older than them, and the
#: defaults
_LATE_KEYS = {
    "has_wc": False, "has_heavy": False, "heavy_v2": False, "has_hdense": False,
    "has_hdense_df": False, "heavy_rows": [], "widx_t": [], "heavy_lanes": [],
    "heavy_rows_df": [], "k_c": 0, "bps": 1, "xdirect": False, "shared_w": False,
}


def _older(aux):
    """aux as an older file holds it: each key the loaders default dropped
    where it holds that default."""
    if isinstance(aux, dict):
        return {k: _older(v) for k, v in aux.items()
                if not (k in _LATE_KEYS and v == _LATE_KEYS[k])}
    if isinstance(aux, list):
        return [_older(a) for a in aux]
    return aux


def _write_older(path, src):
    """Rewrite the JAX-saved file src as an older one: the late aux keys
    dropped, a DIA slab's pad_sub stored as pad (elements), and a routed
    layout's product plan with the trailing w2s leaf older files carry.
    True when the file changed."""
    z = np.load(src)
    before = bytes(z["__meta__"]).decode()
    meta = json.loads(before)
    leaves = [z[f"leaf{i}"] for i in range(len(z.files) - 1)]
    kind, aux = meta["kind"], meta["aux"]
    if kind == "DeviceDIA":
        aux["pad"] = aux.pop("pad_sub") * 128
    if kind in ("RoutedCSR", "RoutedDF"):
        pp = (aux["inner"] if kind == "RoutedDF" else aux)["perm_products"]
        at = 3 + 4 + pp["has_r1"] + pp["has_wc"]
        leaves.insert(at, np.arange(7, dtype=np.int32))
        pp["has_w2s"] = True
        meta["bf16"] = [i + (i >= at) for i in meta["bf16"]]
    meta["aux"] = _older(aux)
    np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                        **{f"leaf{i}": a for i, a in enumerate(leaves)})
    return json.dumps(meta) != before


@pytest.mark.parametrize("mode,case,dtype", [
    ("PL_DIA_ROWS", "banded", "float32"), ("PL_CSR_WINDOW", "fem", "float32"),
    ("PL_CSR_ROUTED", "power_law", "float32"), ("PL_CSR_ROUTED_F64", "spiked", "float64"),
])
def test_older_files_load(tmp_path, mode, case, dtype):
    """A file older than some aux keys (the JAX loader's defaults), a DIA
    slab's pad in elements and a routed plan's trailing w2s leaf loads in
    both packages, and the port's y is torch.equal to its own prepare's."""
    (tcsr, tell), (jcsr, jell) = _both(case)
    src, path = str(tmp_path / "new.npz"), str(tmp_path / "old.npz")
    jser.save_prepared(src, _jprepare(mode, jcsr, jell, dtype))
    assert _write_older(path, src)
    with jax.enable_x64(dtype == "float64"):
        jser.load_prepared(path)
    loaded = tser.load_prepared(path, device="cpu")
    ops = treg.get(mode).prepare(tcsr, tell, Config(dtype=dtype), torch.device("cpu"))
    _assert_leaves_equal(_port_leaves(loaded), _port_leaves(ops))
    x = np.random.default_rng(5).standard_normal(tcsr.shape[1])
    assert torch.equal(_trun(mode, loaded, x, dtype), _trun(mode, ops, x, dtype))
