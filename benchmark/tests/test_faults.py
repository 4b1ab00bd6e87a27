"""Whole runs on the CPU at a small size, with the card's look skipped:
a sound run comes out correct, and each fault planted under the timed
path makes `correct` come out false."""

import pytest

from benchmark import faults
from benchmark.tests.tiny import execute


@pytest.mark.parametrize("cell", ["split_sum.train4096", "split_sum.render_test"])
def test_sound_run_is_correct(cell):
    result = execute(cell, 2**31 + 99)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell,fault", [
    ("split_sum.train4096", "state_unchanged"), ("split_sum.train4096", "half_batch"),
    ("aux_heads.train4096", "state_unchanged"), ("aux_heads.train4096", "half_batch"),
    ("split_sum.render_test", "answer_altered"), ("split_sum.render_test", "half_rays"),
    ("split_sum.render_orbit", "answer_altered"), ("split_sum.render_orbit", "half_rays")])
def test_fault_is_caught(cell, fault):
    undo = {**faults.TRAIN, **faults.RENDER}[fault]()
    try:
        result = execute(cell, 2**31 + 77)
    finally:
        undo()
    assert not result["correct"], result["checks"]
