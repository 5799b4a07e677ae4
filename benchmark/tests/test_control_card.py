"""The control on the card: the reference with TF32 products in the
program's place has to come out not correct, and the program as it is
correct, at a size a test run holds (the cells' own sizes are read with
benchmark/readings.py)."""

import pytest

from benchmark.control import tf32_search
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = ["glove100-lsh.global-b256", "glove100-ivf.auto-b2048", "glove100-lsh.scan-b10000"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(card, name):
    cell = tiny_cell(name, rows=200_000, batch=256, pool=1024)
    _, line = run_tiny(cell, devices=[card], wrap=tf32_search(card, 10), program=False)
    assert not line["correct"], line["checks"]
    assert line["checks"]["dist_err"]["value"] > line["checks"]["dist_err"]["at_most"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_program_on_the_card_is_correct(card, name):
    cell = tiny_cell(name, rows=200_000, batch=256, pool=1024)
    _, line = run_tiny(cell, devices=[card])
    assert line["correct"], line["checks"]
