"""Test configuration: run everything on the CPU with 8 virtual devices
and float64 enabled, so numerics match the reference's double precision and
the multi-device sharding paths execute without accelerators.

Run as `JAX_PLATFORMS=cpu python -m pytest tests/`; the platform is also
pinned to the CPU at the config level here. The GPU path is exercised by
`python chip_smoke.py` (one card) and `--four-cards`, one process per card."""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
