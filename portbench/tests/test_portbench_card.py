"""On the card: each cell at its own size over a short window is correct,
traced, and the control is not (``python -m pytest portbench/tests -m
cuda``)."""

import time

import pytest

from portbench import breakers, harness
from portbench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", tiny.SEAL_CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    result, _ = harness.run(cell, 2 ** 31 + 9, 2.0, True,
                            time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["kernel_roofline.seal"]["value"] <= 100


def test_the_control_is_not_correct_on_the_card(card):
    result, _ = harness.run("seal_backlog_30mib", 2 ** 31 + 10, 2.0, False,
                            time.perf_counter(), patch=breakers.control,
                            overrides={"traffic": {"check_share": 0.5}})
    assert result["correct"] is False
