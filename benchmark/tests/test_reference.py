"""The plain reference against the port's plain path on the CPU, at a
small field: three updates of each training cell and the sampled pixels
of each render cell, both at float32, agree to rounding."""

import pytest
import torch

from benchmark.reference import nerf as ref
from benchmark.tests.tiny import run_of

CELLS = ["split_sum.train4096", "aux_heads.train4096", "split_sum.render_test",
         "split_sum.render_orbit"]
# float32 sums in other orders: losses and gradients to ~1e-6; a leaf's
# change to ~1e-3, since Adam moves an element whose gradient is nought to
# rounding by up to lr either way
TOLERANCE = {"loss": 1e-5, "first_grad": 1e-4, "change": 2e-3, "buffer_gap": 1e-4,
             "rgb_gap": 1e-4, "first_grad_median": 1e-4, "change_median": 2e-3}


@pytest.mark.parametrize("cell", CELLS)
def test_matches_port(cell):
    torch.manual_seed(0)
    run, wl = run_of(cell, 2**33 + 5)
    run.window(0.2)
    readings = run.check()
    assert all(v < TOLERANCE[k] for k, v in readings.items()), readings


def test_precisions():
    args = {"compute_dtype": "bf16_grad"}
    assert ref.stated(args) == ref.Precision("bf16", "f32", "f32")
    assert ref.control(args) == ref.Precision("fp8", "tf32", "tf32")
    x = torch.tensor([1.0 + 2**-12, 3.0 + 2**-9, -1.5e-3])
    assert torch.equal(ref.quantize(x, "tf32"), torch.tensor([1.0, 3.0 + 2**-9, -1.5e-3]).to(
        torch.float32).contiguous().view(torch.int32).add(0x1000).bitwise_and(-0x2000)
        .view(torch.float32))
    assert ref.quantize(x, "bf16")[0] == 1.0
    q = ref.quantize(torch.linspace(-1, 1, 101), "fp8")
    assert len(torch.unique(q)) < 101 and q.abs().max() == 1.0


def test_control_departs():
    """The control's readings at the small size stand clear of the
    stated precision's, which agree with the port to rounding."""
    run, wl = run_of("split_sum.train4096", 2**33 + 6)
    run.window(0.2)
    run.check()
    assert max(run.control().values()) > 1e-3


def test_blocks_sum_to_the_update():
    """The reference's update is the same whether its gradients are summed
    over blocks of rays or taken over the batch at once."""
    run, _ = run_of("aux_heads.train4096", 2**33 + 7)
    a = run.args
    lr_of = ref.lr_schedule(a["lrate"], a["lrate_decay"] * 1000.0, {})
    whole, blocked = (ref.train_steps(run.variables0, run.lut, run.scene["arrays"], run.scene,
                                      run.checked_draws, a, ref.stated(a), run.counts, lr_of,
                                      block=b) for b in (64, 16))
    assert whole["losses"] == pytest.approx(blocked["losses"], rel=1e-5)
    # the sums' order moves a gradient by rounding; Adam's step is about lr
    # whatever the gradient's size, so an element whose gradient is nought
    # to rounding moves by up to lr either way, which shows in a leaf's
    # change at ~1e-3
    for key, rel in (("first_grad", 1e-4), ("change", 2e-3)):
        for k, v in whole[key].items():
            assert blocked[key][k] == pytest.approx(v, rel=rel, abs=1e-9), (key, k)
