"""The port's numpy prepare paths, for the tests that hold its layouts array
for array against the JAX package's numpy prepares (another test process
may build the native library meanwhile)."""
import contextlib

import pytest

from spmv_openmp_cuda_tpu_torch.io import native


@contextlib.contextmanager
def numpy_path():
    """Inside the block the native library is not loaded
    (`native.load_library` returns None), so every prepare runs its numpy
    fallback."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "load_library", lambda: None)
        yield
