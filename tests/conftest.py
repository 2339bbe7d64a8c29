"""Test configuration: an 8-device virtual CPU mesh + f64.

Multi-chip logic is validated on CPU per SURVEY.md §4.  The suite runs
on the CPU unless JAX_PLATFORMS names another backend: the gpu-marked
tests run on a card with JAX_PLATFORMS=cuda (see README).  XLA_FLAGS is
read lazily at backend init, so setting it here is fine.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# No persistent compilation cache under pytest: CPU compiles are fast,
# and long multi-graph test processes have segfaulted inside XLA's
# executable DESERIALIZATION when reading entries written by other
# topologies (1-device CLI runs share the directory).  Must be set
# before lorads_tpu is imported (lorads_tpu/__init__.py reads it).
os.environ.setdefault("LORADS_TPU_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
