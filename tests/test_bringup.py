"""Device bring-up on the CPU: the peak table, where the compile cache
goes, the ambient-dtype eigh and LU paths, and chip_smoke.py's
independent solution verifier."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


class _FakeDevice:
    def __init__(self, kind):
        self.device_kind = kind
        self.platform = "gpu"


def test_chip_peaks_h100():
    from lorads_tpu.utils.profiling import chip_peaks

    p = chip_peaks(_FakeDevice("NVIDIA H100 80GB HBM3"))
    assert p == {"bf16": 989e12, "f32": 67e12, "f64": 67e12,
                 "hbm": 3.35e12}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200",
                                  "NVIDIA A100-SXM4-80GB"])
def test_chip_peaks_unknown_device_raises(kind):
    from lorads_tpu.utils.profiling import chip_peaks

    with pytest.raises(ValueError, match="no peak rates"):
        chip_peaks(_FakeDevice(kind))


@pytest.mark.parametrize("case", ["env_dir", "default", "opt_out"])
def test_compile_cache_location(case, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "LORADS_TPU_NO_COMPILE_CACHE")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if case == "env_dir":
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    elif case == "opt_out":
        env["LORADS_TPU_NO_COMPILE_CACHE"] = "1"
    code = ("import jax, lorads_tpu\n"
            "print(jax.config.jax_compilation_cache_dir)\n"
            "print(jax.config.jax_enable_compilation_cache)\n")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    cache_dir, enabled = out.stdout.split()
    if case == "env_dir":
        assert cache_dir == str(tmp_path / "cc") and enabled == "True"
    elif case == "default":
        assert cache_dir == os.path.join(REPO, ".jax_cache")
        assert enabled == "True"
    else:
        assert enabled == "False"


def test_exact_min_eig_f64_matches_numpy():
    from lorads_tpu.alg.solver import _EIG_K, _exact_min_eig

    rng = np.random.default_rng(0)
    A = rng.standard_normal((3, 40, 40))
    A = 0.5 * (A + np.swapaxes(A, 1, 2))
    # clustered low end: an f32 eigh cannot resolve these to 1e-12
    A[:, 0, 0] -= 30.0
    A[:, 1, 1] -= 30.0 + 1e-9
    lams, vecs = _exact_min_eig(jnp.asarray(A))
    assert lams.dtype == jnp.float64 and vecs.dtype == jnp.float64
    ref = np.linalg.eigvalsh(A)[:, :_EIG_K]
    np.testing.assert_allclose(np.asarray(lams), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # vecs are unit eigenvectors: A v = lam v
    v = np.asarray(vecs)
    res = np.einsum("bij,bkj->bki", A, v) - np.asarray(lams)[:, :, None] * v
    assert np.abs(res).max() <= 1e-11 * np.abs(ref).max()


def test_spectral_repair_step_solves_at_f64():
    from lorads_tpu.alg.spectral_repair import _prox_solve

    rng = np.random.default_rng(1)
    G = rng.standard_normal((24, 30)) * np.logspace(0, 6, 24)[:, None]
    M = G @ G.T
    t = rng.standard_normal(24)
    reg = 1e-6 * np.trace(M) / 24
    alpha = _prox_solve(jnp.asarray(M), reg, jnp.asarray(t))
    assert alpha.dtype == jnp.float64
    ref = np.linalg.solve(M + reg * np.eye(24), t)
    # an f32 solve of this system misses by ~1e-3 relative
    np.testing.assert_allclose(np.asarray(alpha), ref, rtol=1e-8,
                               atol=1e-8 * np.abs(ref).max())


def test_smoke_refuses_without_gpu():
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.require_gpu()


def test_smoke_compare_bounds():
    ref = np.array([1.0, -2.0, 3.0])
    absref = np.array([1.0, 2.0, 3.0])
    chip_smoke.compare("ok", ref + 1e-6 * absref, ref, absref, np.float32)
    with pytest.raises(AssertionError, match="exceeds bound"):
        chip_smoke.compare("bad", ref + 1e-4 * absref, ref, absref,
                           np.float32)
    with pytest.raises(AssertionError, match="exceeds bound"):
        chip_smoke.compare("bad64", ref + 1e-11 * absref, ref, absref,
                           np.float64)


_SOLVED = {}


def _solve(name, tmp_path_factory):
    """CLI solve of a fixture with --solOut, once per fixture."""
    if name not in _SOLVED:
        from lorads_tpu.io.sdpa import read_sdpa

        path = os.path.join(REPO, "tests", "fixtures", name)
        sol = str(tmp_path_factory.mktemp("sol") / "sol.npz")
        rep, _ = chip_smoke.run_cli([path, "--quiet", "--solOut", sol])
        assert rep["status"] == "primal_dual_optimal"
        assert rep["dtype"] == "float64"
        _SOLVED[name] = (read_sdpa(path), sol)
    return _SOLVED[name]


@pytest.mark.parametrize("perturb", ["none", "dual", "factor"])
@pytest.mark.parametrize("name", ["mc_gtoy60.dat-s", "theta_gtoy60.dat-s",
                                  "hand_multiblock.dat-s"])
def test_smoke_verifier(name, perturb, tmp_path_factory, tmp_path):
    """The independent verifier accepts a solve's exported solution and
    rejects one whose dual or primal factor moved by 1%."""
    problem, sol = _solve(name, tmp_path_factory)
    with np.load(sol) as z:
        arrs = dict(z)
    if perturb == "dual":
        arrs["y"] = arrs["y"] * 1.01
    elif perturb == "factor":
        arrs["f0"] = arrs["f0"] * 1.01
    path = str(tmp_path / "s.npz")
    np.savez(path, **arrs)
    errs = chip_smoke.verify_solution(problem, path, check_dual=True)
    if perturb == "none":
        chip_smoke.check_bands(name, errs)
        assert errs["pinf"] <= 1e-5 and errs["dinf"] <= 5e-5
    else:
        with pytest.raises(AssertionError, match="recomputed"):
            chip_smoke.check_bands(name, errs)
