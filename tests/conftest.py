"""Test harness configuration.

Runs the whole suite on an 8-virtual-device CPU mesh with float64
enabled (SURVEY.md SS4: cluster-free distributed tests + f64 oracle
comparisons).  Environment must be set BEFORE jax is imported anywhere.
"""

import os

# XLA_FLAGS is read when the CPU backend starts; the platform choice is
# made here as well so a plain ``pytest`` never opens an accelerator.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from ltjax import compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# XLA CPU compiles are slow; cache them across tests and invocations
compile_cache.configure(min_compile_secs=0.2)

