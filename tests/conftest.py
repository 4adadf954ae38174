"""Test configuration: run everything on a virtual 8-device CPU mesh.

The platform is forced through jax.config before the backend initialises;
multi-chip sharding is validated on 8 virtual CPU devices.  The compiled
GPU kernels are exercised on the card by chip_smoke.py.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # read by any subprocesses

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:  # older jax: fall back to the XLA flag
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
jax.config.update("jax_enable_x64", False)
