"""Tests of the benchmark's harness.  They run on the CPU at small sizes;
those marked ``gpu`` need a CUDA card and skip without one:

    python -m pytest benchmark/tests            # here
    python -m pytest -m gpu benchmark/tests     # on a machine with a card
"""
import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda:0"


def small_cell(name, traffic=None, **sizes):
    """The cell ``name`` of BENCHMARK.json with its configuration cut to
    ``sizes`` and its traffic updated by ``traffic`` (a test's own, never
    a run's)."""
    from fvbench import registry
    cell = registry.find_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(sizes)
    return cell._replace(config=cfg, traffic=dict(cell.traffic, **(traffic or {})))


SMALL_CLIP = dict(width=128, height=96, frames=12, pairs=2)
SMALL_SET = dict(width=64, height=48, references=2, pairs=250)
