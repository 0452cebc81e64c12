import os

# Default to the CPU backend with 8 virtual devices so multi-device
# sharding logic is exercised without accelerators. Must run before the
# first jax import. On a card, `JAX_PLATFORMS=cuda python -m pytest -m gpu`
# runs the tests marked `gpu`, which decide inside the test whether a card
# is present.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
