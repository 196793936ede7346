"""Test config: the tests run on the CPU, with 8 virtual devices for the
sharding tests, whatever accelerator the machine has.

The GPU path is exercised by `python chip_smoke.py` on a machine with a card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# references compare at full float32; individual tests may locally enable
# x64 via context.
jax.config.update("jax_default_matmul_precision", "highest")
# tests compile many small programs; keep them out of the persistent cache
# that the entry points turn on
jax.config.update("jax_enable_compilation_cache", False)
