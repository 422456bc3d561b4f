import os

# Tests run on the CPU with a virtual 8-device mesh (multi-device sharding is
# validated without accelerator hardware, like the reference's `mpirun -np N`
# on one box); correctness tests are f64.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
