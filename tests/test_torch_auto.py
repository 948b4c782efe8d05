"""AutoSpMV and the CLI of the PyTorch port against the JAX package, on the
CPU (the kernels' plain versions). Every format the JAX package accepts runs
its own engine; an engine's refusal falls back where the JAX package's
does, never elsewhere."""
import numpy as np
import pytest
import torch

import spmv_openmp_cuda_tpu as J
from spmv_openmp_cuda_tpu.models import auto as jauto
from spmv_openmp_cuda_tpu.ops import registry as jreg
from spmv_openmp_cuda_tpu.utils import synth as jsynth
import spmv_openmp_cuda_tpu_torch as T
from spmv_openmp_cuda_tpu_torch import cli
from spmv_openmp_cuda_tpu_torch.config import Config
from spmv_openmp_cuda_tpu_torch.io.mmio import write_mtx
from spmv_openmp_cuda_tpu_torch.io.vectors import read_vector_raw, write_vector_str
from spmv_openmp_cuda_tpu_torch.models import auto as tauto
from spmv_openmp_cuda_tpu_torch.ops.oracle import serial_csr_spmv
from spmv_openmp_cuda_tpu_torch.utils import synth as tsynth
from torch_numpy_path import numpy_path


@pytest.fixture(autouse=True, scope="module")
def _numpy_prepare():
    """The port's numpy prepare paths (see torch_numpy_path)."""
    with numpy_path():
        yield


DIA_CLASS = {
    "raefsky1_like": ("preset", dict(name="raefsky1_like")),
    "cavity10_like": ("preset", dict(name="cavity10_like")),
    "fringe": ("banded", dict(m=2500, n=2500, bandwidth=12, fill=1.0, exact_nnz=66000, seed=2)),
    "band": ("banded", dict(m=500, n=500, bandwidth=5, fill=0.9, seed=1)),
}


def _csrs(case):
    gen, kw = case
    return T.coo_to_csr(getattr(tsynth, gen)(**kw)), J.coo_to_csr(getattr(jsynth, gen)(**kw))


def _close(y_t, y_j):
    assert isinstance(y_t, torch.Tensor) and y_t.dtype == torch.float32
    y_t, y_j = y_t.double().numpy(), np.asarray(y_j, np.float64)
    assert y_t.shape == y_j.shape
    bound = 1e-5 * np.abs(y_j) + 1e-6 * np.abs(y_j).max()
    assert np.all(np.abs(y_t - y_j) <= bound), np.abs(y_t - y_j).max()


@pytest.mark.parametrize("name", list(DIA_CLASS))
def test_select_format_agrees(name):
    tcsr, jcsr = _csrs(DIA_CLASS[name])
    fmt = tauto.select_format(tcsr)
    assert fmt == jauto.select_format(jcsr)
    assert fmt in ("dia", "dia_resid")


def test_select_format_raises_on_power_law():
    # the routed engine is ported: both packages pick it
    case = ("power_law", dict(m=900, n=900, avg_nnz_per_row=4.0, seed=11))
    tcsr, jcsr = _csrs(case)
    assert jauto.select_format(jcsr) == "routed"
    assert tauto.select_format(tcsr) == "routed"


@pytest.mark.parametrize(
    "name,fmt", [("raefsky1_like", "dia_resid"), ("cavity10_like", "dia"), ("fringe", "dia_resid")]
)
def test_auto_spmv_matches_jax(name, fmt):
    tcsr, jcsr = _csrs(DIA_CLASS[name])
    tm = tauto.AutoSpMV.from_csr(tcsr, device="cpu")
    jm = jauto.AutoSpMV.from_csr(jcsr)
    assert tm.format == jm.format == fmt
    assert tm.device == torch.device("cpu")
    x = np.random.default_rng(5).standard_normal(tcsr.shape[1])
    y = tm(x)
    assert y.shape == (tcsr.shape[0],)
    _close(y, jm(x))
    _close(tm(torch.as_tensor(x, dtype=torch.float32)), jm(x))
    assert np.abs(y.double().numpy() - serial_csr_spmv(tcsr, x)).max() <= 1e-5 * np.abs(
        serial_csr_spmv(tcsr, x)).max()


def test_auto_spmv_from_file_matches_jax(tmp_path):
    coo = tsynth.banded(1000, 1000, 6, fill=1.0, exact_nnz=13500, seed=4)
    path = str(tmp_path / "m.mtx.gz")
    write_mtx(path, coo)
    tm = T.AutoSpMV.from_file(path, device="cpu")
    jm = J.AutoSpMV.from_file(path)
    assert tm.format == jm.format
    x = np.random.default_rng(6).standard_normal(1000)
    _close(tm(x), jm(x))


def test_auto_spmv_never_substitutes_an_engine():
    csr = T.coo_to_csr(tsynth.banded(500, 500, 5, fill=0.9, seed=1))
    # the window engine is ported: an explicit format="window" runs it
    win = tauto.AutoSpMV.from_csr(csr, format="window", device="cpu")
    assert win.format == "window"
    x = np.random.default_rng(7).standard_normal(500)
    o = serial_csr_spmv(csr, x)
    assert np.abs(win(x).double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6
    # so is the routed engine
    routed = tauto.AutoSpMV.from_csr(csr, format="routed", device="cpu")
    assert routed.format == "routed"
    assert np.abs(routed(x).double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6
    # so are lanes, ell_t and binned (the last two the reference-shaped
    # layouts): each format runs its own engine
    for fmt in ("lanes", "ell_t", "binned"):
        model = tauto.AutoSpMV.from_csr(csr, format=fmt, device="cpu")
        assert model.format == fmt
        y = model(x)
        assert y.dtype == torch.float32 and y.shape == (500,)
        assert np.abs(y.double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6
    with pytest.raises(ValueError, match="unknown format"):
        tauto.AutoSpMV.from_csr(csr, format="csr", device="cpu")
    # float64 runs the double-float engines; lanes (an f32 kernel) maps to
    # the f64 binned engine, as in the JAX package
    f64 = tauto.AutoSpMV.from_csr(csr, cfg=Config(dtype="float64"), device="cpu")
    assert f64.format == "dia" and f64(x).dtype == torch.float64
    lanes64 = tauto.AutoSpMV.from_csr(csr, cfg=Config(dtype="float64"), format="lanes", device="cpu")
    assert lanes64.format == "binned"
    assert np.abs(lanes64(x).numpy() - o).max() <= 1e-12 * np.abs(o).max()
    # DIA fill budget exceeded: the routed engine takes over, as in the JAX
    # package
    rnd = T.coo_to_csr(tsynth.random_uniform(400, 400, 0.02, seed=3))
    fell = tauto.AutoSpMV.from_csr(rnd, format="dia", device="cpu")
    assert fell.format == "routed"
    o = serial_csr_spmv(rnd, x[:400])
    assert np.abs(fell(x[:400]).double().numpy() - o).max() <= 1e-5 * np.abs(o).max() + 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tauto.AutoSpMV.from_csr(csr, device="cuda")


@pytest.mark.parametrize("name", ["prepare_dia", "prepare_routed_auto", "prepare_lanes_small"])
def test_public_prepares_default_to_the_card(name):
    """The package-level prepares (lazy exports, as in the JAX package) run
    on cuda unless the caller passes device="cpu"; without a card that
    default raises, as AutoSpMV.from_csr's does."""
    csr = T.coo_to_csr(tsynth.banded(600, 600, 4, seed=3))
    prepare = getattr(T, name)
    assert T.RoutedError and T.LanesError and T.save_prepared and T.load_prepared
    cpu = prepare(csr, device="cpu")
    first = cpu.data if name == "prepare_dia" else cpu.vals
    assert first.device.type == "cpu"
    if torch.cuda.is_available():
        mat = prepare(csr)
        assert (mat.data if name == "prepare_dia" else mat.vals).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            prepare(csr)


@pytest.fixture
def raefsky_mtx(tmp_path):
    path = str(tmp_path / "raefsky1_like.mtx")
    write_mtx(path, tsynth.preset("raefsky1_like"))
    return path


@pytest.mark.parametrize("mode", ["AUTO", "PL_DIA_RESID_BF16", "DIA_ROWS"])
def test_cli_cpu_check(raefsky_mtx, mode, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    rc = cli.main([raefsky_mtx, "RNDVECT", mode, "--device", "cpu", "--check", "--no-dump"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "#check: OK" in out
    assert "#matrix: raefsky1_like.mtx 3242 3242 293409" in out
    want = "PL_DIA_RESID" if mode == "AUTO" else mode
    line = [ln for ln in out.splitlines() if ln.startswith("computeMode:")][-1]
    assert line.startswith(f"computeMode:{want} elapsed:")
    assert "elapsedInternal:" in line and "GFLOPS:" in line
    if mode == "AUTO":
        assert "#auto: format=dia_resid -> PL_DIA_RESID" in out


def test_cli_refusals(raefsky_mtx, tmp_path, capsys, monkeypatch):
    # --save-prepared then --load-prepared: the same y dump (CSR_ROWS saves
    # a DeviceCSR); AUTO's DIA+residual pair is not serializable, as in the
    # JAX package; a kind/mode mismatch exits 1
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    vec, npz = str(tmp_path / "x.txt"), str(tmp_path / "p.npz")
    write_vector_str(vec, np.random.default_rng(5).standard_normal(3242))
    dumps = []
    for extra in (["--save-prepared", npz], ["--load-prepared", npz]):
        assert cli.main([raefsky_mtx, vec, "--device", "cpu", "--check", *extra]) == 0
        out = capsys.readouterr().out
        assert "#check: OK" in out and ("#prepared saved:" in out) == (extra[0] == "--save-prepared")
        dumps.append(read_vector_raw(str(tmp_path / "outVectorDumpRaw")))
    np.testing.assert_array_equal(dumps[0], dumps[1])
    assert cli.main([raefsky_mtx, vec, "AUTO", "--device", "cpu", "--no-dump",
                     "--save-prepared", str(tmp_path / "r.npz")]) == 0
    assert "#prepared not serializable for mode PL_DIA_RESID" in capsys.readouterr().err
    assert cli.main([raefsky_mtx, vec, "ELL_ROWS", "--device", "cpu", "--load-prepared", npz]) == 1
    assert "loaded prepared format DeviceCSR does not match mode ELL_ROWS" in capsys.readouterr().err
    # CSR_ROWS is ported, and the default mode, as in the JAX package
    assert cli.main([raefsky_mtx, "RNDVECT", "--device", "cpu", "--no-dump"]) == 0
    assert "computeMode:CSR_ROWS " in capsys.readouterr().out
    rnd = str(tmp_path / "rnd.mtx")
    write_mtx(rnd, tsynth.power_law(900, 900, 4.0, seed=11))
    # a power-law matrix is no refusal any more: AUTO runs the routed engine
    assert cli.main([rnd, "RNDVECT", "AUTO", "--device", "cpu", "--no-dump", "--check"]) == 0
    assert "#auto: format=routed -> PL_CSR_ROUTED" in capsys.readouterr().out
    # an explicit mode whose exact prepare refuses the matrix exits 1
    assert cli.main([rnd, "RNDVECT", "PL_DIA_ROWS", "--device", "cpu", "--no-dump"]) == 1
    assert "ERROR:" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert cli.main([raefsky_mtx, "RNDVECT", "--no-dump"]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["--list-modes"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()]
    assert sorted(listed) == sorted(jreg.names())
    assert listed[:11] == ["CSR_ROWS", "CSR_ROWS_GROUPS", "CSR_TILES", "CSR_TILES_ALLOCD",
                           "ELL_ROWS", "ELL_ROWS_GROUPS", "ELL_TILES", "ELL_ROWS_T",
                           "ELL_ROWS_NOSIMD", "ELL_ROWS_NORL", "CSR_ROWS_BINNED"]
