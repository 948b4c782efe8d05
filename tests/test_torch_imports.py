"""Every module of the PyTorch port imports on its own, as the first import
of a fresh interpreter, and pulls in neither jax nor the JAX package.

One subprocess imports torch once; then, for each module, it drops every
`spmv_openmp_cuda_tpu_torch*` entry from sys.modules (and any jax or JAX
package entry, so that each module is judged alone) and imports that module
first, recording the error if any. `__main__` runs the CLI when imported: it
is imported with `--list-modes` on its command line and must exit 0.
"""
import json
import pathlib
import subprocess
import sys

import pytest

_PKG = "spmv_openmp_cuda_tpu_torch"
_ROOT = pathlib.Path(__file__).resolve().parent.parent

MODULES = sorted(
    ".".join(p.relative_to(_ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (_ROOT / _PKG).rglob("*.py")
)

_PROBE = r"""
import contextlib, importlib, io, json, sys
import torch  # once: the port's modules are what each import measures

def drop():
    for name in list(sys.modules):
        if name.split(".")[0] in (%(pkg)r, "jax", "jaxlib", "spmv_openmp_cuda_tpu"):
            del sys.modules[name]

out = {}
for name in %(modules)r:
    drop()
    err = None
    try:
        if name.endswith(".__main__"):
            sys.argv = [%(pkg)r, "--list-modes"]
            with contextlib.redirect_stdout(io.StringIO()):
                try:
                    importlib.import_module(name)
                except SystemExit as e:
                    if e.code not in (0, None):
                        err = "SystemExit(%%r)" %% (e.code,)
        else:
            importlib.import_module(name)
    except BaseException as e:
        err = "%%s: %%s" %% (type(e).__name__, e)
    out[name] = {"error": err, "jax": "jax" in sys.modules,
                 "jax_package": "spmv_openmp_cuda_tpu" in sys.modules}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE % {"pkg": _PKG, "modules": MODULES}],
        capture_output=True, text=True, timeout=120, cwd=_ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_module_is_listed():
    assert len(MODULES) >= 40 and f"{_PKG}.ops.routed_cuda" in MODULES
    for mod in ("io.native", "formats.serialize", "models.solvers"):
        assert f"{_PKG}.{mod}" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_first(imported, module):
    rec = imported[module]
    assert rec["error"] is None, rec["error"]
    assert not rec["jax"] and not rec["jax_package"], rec
