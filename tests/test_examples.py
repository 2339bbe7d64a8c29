"""Smoke-run every examples/*.py script (VERDICT r1: examples were
exercised by no test, so a LoradsSolver signature drift could break
them silently).  Each runs in a subprocess on the virtual CPU mesh —
the same environment their own headers document."""

import os
import pathlib
import subprocess
import sys

import pytest

EXAMPLES = sorted(
    (pathlib.Path(__file__).resolve().parents[1] / "examples")
    .glob("*.py"))


@pytest.mark.parametrize("script", EXAMPLES, ids=lambda p: p.stem)
def test_example_runs(script, tmp_path):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        LORADS_TPU_NO_COMPILE_CACHE="1",
    )
    proc = subprocess.run(
        [sys.executable, str(script)], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{script.name} failed\n--- stdout ---\n{proc.stdout[-4000:]}"
        f"\n--- stderr ---\n{proc.stderr[-4000:]}")
