"""Shared fixtures of the benchmark's own tests (run with
`python -m pytest perfbench/tests` from the repository's root; they need
no card except those marked `chip`, which skip without one)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


# a cell shrunk to what a CPU test can run: a 25 x 16 m store, a few hundred
# particles, a sparse lidar, a short warm-up
SMALL_2D = {"config": {"map": {"cells": [500, 320]},
                       "params": {"min_particles": 200, "max_particles": 600}},
            "traffic": {"warmup_s": 3.0, "trace_s": 1.0}}
SMALL_3D = {"config": {"map": {"cells": [500, 320, 50]},
                       "params": {"min_particles": 200, "max_particles": 600},
                       "sensor": {"azimuth_steps": 120, "rings": 8, "range_max": 8.0}},
            "traffic": {"warmup_s": 3.0, "trace_s": 1.0}}
