"""Test configuration: run everything on a virtual 8-device CPU mesh.

The tests run on the host CPU with 8 virtual devices, so multi-device
sharding is exercised, per the standard JAX testing recipe. Tests that need
the card carry the `gpu` marker and skip here; `chip_smoke.py` runs the
system on the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# jax may already have been imported (pytest plugins), in which case the env
# var was captured too early — force the config directly.
jax.config.update("jax_platforms", "cpu")

from orbslam2_tpu.utils import setup_compile_cache  # noqa: E402

setup_compile_cache()
