import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.join(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))), "src")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (the port's CUDA kernels); skips without "
        "one — run on the card with -m gpu")
