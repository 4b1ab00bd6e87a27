"""On the card, at each cell's own size, one seed: the program's numbers
are within the cell's limits and the control's (the reference one step
below the stated precision in the program's place) break one or more of
them; a planted fault breaks one or more. `benchmark/control.py` takes
the same readings over many seeds."""

import time

import pytest
import torch

from benchmark import faults, harness

CELLS = ["split_sum.train4096", "aux_heads.train4096", "split_sum.render_test",
         "split_sum.render_orbit"]


def readings(cell: str, seed: int, device, control: bool = False) -> tuple[dict, dict, dict]:
    wl = harness.read_json(harness.BENCH / "workloads" / f"{cell}.json")
    cfg = harness.read_json(harness.BENCH / "configs" / f"{wl['config']}.json")
    driver = harness.load_module(harness.BENCH / "traffic" / f"{wl['traffic']['kind']}.py")
    run = driver.Run(cfg, wl["traffic"], seed, device, harness.Phases(time.perf_counter()))
    run.window(3.0)
    got = run.check()
    ctl = run.control() if control else {}
    del run
    torch.cuda.empty_cache()
    return {k: got[k] for k in wl["limits"]}, {k: ctl[k] for k in wl["limits"] if ctl}, wl


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell, cuda_device):
    got, ctl, wl = readings(cell, 2**32 + 17, cuda_device, control=True)
    assert all(got[k] <= lim for k, lim in wl["limits"].items()), got
    assert any(ctl[k] > lim for k, lim in wl["limits"].items()), ctl


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", [
    ("split_sum.train4096", "half_batch"), ("aux_heads.train4096", "state_unchanged"),
    ("split_sum.render_test", "answer_altered"), ("split_sum.render_orbit", "half_rays")])
def test_fault_fails_on_card(cell, fault, cuda_device):
    undo = {**faults.TRAIN, **faults.RENDER}[fault]()
    try:
        got, _, wl = readings(cell, 2**32 + 18, cuda_device)
    finally:
        undo()
    assert any(got[k] > lim for k, lim in wl["limits"].items()), got
