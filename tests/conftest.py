import os
import sys

# src layout import path (tests run as `PYTHONPATH=src pytest tests/`, but
# make it work without the env var too)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# real single device; only the dry-run entrypoint forces 512 host devices.
# SPMD tests that need >1 device spawn subprocesses (see spmd_util.py).


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow_spmd: subprocess SPMD test (8 fake host devices, minutes of "
        "compile); skip with -m 'not slow_spmd' for the fast tier")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (the port's CUDA kernels); skips without "
        "one — run on the card with -m gpu")
