"""Test config: CPU backend with native f64 and a virtual 8-device mesh.

Unit tests run on the CPU backend, where float64 is native (ground truth)
and multi-device sharding is emulated with xla_force_host_platform_
device_count. Tests that only mean something on a GPU carry the `gpu`
marker and skip here; `python chip_smoke.py` runs what they cover on the
card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
