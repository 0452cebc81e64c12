#!/bin/bash
# CPU test run: JAX on the CPU backend with 8 virtual devices for the mesh
# tests. Tests marked `gpu` skip here; `python chip_smoke.py` runs their
# checks on a card.
exec env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python -m pytest "${@:-tests/}" -q
