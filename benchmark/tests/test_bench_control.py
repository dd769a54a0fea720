"""The control: the reference in bfloat16 in the program's place fails the
limits of every cell (on the chip at the cells' sizes, PERF.md; here at a
small size)."""
import pytest

from conftest import SMALL_CLIP, SMALL_SET, small_cell
from fvbench import control


@pytest.mark.parametrize("workload,sizes", [("4k-clip", SMALL_CLIP), ("4k-clip-gaze", SMALL_CLIP),
                                            ("kadid-batch", SMALL_SET),
                                            ("kadid-batch-4proc", SMALL_SET)])
def test_bfloat16_fails(workload, sizes):
    cell = small_cell(workload, traffic={"pairs": 200}, **sizes)
    got = control.readings(cell, 2**31 + 3, "cpu")
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)


@pytest.mark.gpu
def test_bfloat16_fails_on_the_card(card):
    cell = small_cell("4k-clip", width=1920, height=1080, frames=30, pairs=1)
    got = control.readings(cell, 7, card)
    assert any(got[k] > lim for k, lim in cell.limits.items()), (got, cell.limits)
