"""Kernel comparisons at real widths on an NVIDIA GPU.

chip_smoke.py's Phase 1 checks as tests: every kernel of the solve
path, compiled for the card at f32 and f64, against a NumPy float64
oracle on the Max-Cut n=20000 pattern and the theta300 dense block.
They need a card and skip elsewhere; on one, run

    JAX_PLATFORMS=cuda python -m pytest -m gpu -n 0 tests/test_gpu.py
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda on a card)")


@pytest.fixture(scope="module")
def maxcut(gpu):
    from lorads_tpu.io import generators

    return generators.maxcut(**chip_smoke.SIZES["maxcut_kernels"])


@pytest.fixture(scope="module")
def theta(gpu):
    from lorads_tpu.io.sdpa import read_sdpa

    return read_sdpa(os.path.join(chip_smoke.FIXTURES, "theta300.dat-s"))


def test_f32_matmul_is_not_tf32(gpu):
    chip_smoke.check_no_tf32()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_maxcut20000(maxcut, dtype):
    import jax.numpy as jnp

    chip_smoke.kernels_maxcut(maxcut, getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_theta300(theta, dtype):
    import jax.numpy as jnp

    chip_smoke.kernels_theta(theta, getattr(jnp, dtype))
