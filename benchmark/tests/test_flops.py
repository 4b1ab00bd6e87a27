"""The operation and byte counts against the bounds the repository's
smoke test printed (PERF.md's table of kernels) and the port's shapes."""

import numpy as np
import pytest

from benchmark import flops
from benchmark.inputs import position_direction_mlp_layers, position_mlp_layers

F = flops.Field()
ARGS = {"netdepth": 8, "netwidth": 256, "multires": 10, "multires_views": 4,
        "coarse_radiance_number": 3}


def test_k1_anchors():
    assert 2 * flops.field_macs(F, False) * 131_072 / 1e12 == pytest.approx(0.2086, abs=5e-5)
    assert 2 * flops.field_macs(F, True) * 1_572_864 / 1e12 == pytest.approx(1.545, abs=5e-4)
    # the bounds in the table: 3.11 ms full, 23.07 ms density at 67 TFLOP/s
    assert flops.k1_bound(F, 131_072, False).seconds * 1e3 == pytest.approx(3.11, abs=0.01)
    assert flops.k1_bound(F, 1_572_864, True).seconds * 1e3 == pytest.approx(23.07, abs=0.01)


def test_train_kernel_anchors():
    assert flops.k2_flops(F) / 1e6 == pytest.approx(1.59, abs=5e-3)
    assert flops.k3_flops(F) / 1e6 == pytest.approx(3.30, abs=5e-3)
    # K3 at 98,304 points: 0.325 TFLOP, bound 0.328 ms by operations
    b = flops.k3_bound(F, 98_304)
    assert b.flops / 1e12 == pytest.approx(0.325, abs=1e-3)
    assert b.seconds * 1e3 == pytest.approx(0.328, abs=2e-3)
    # K2 at 98,304 points: bound by bytes, 0.566 GB (with the pack's padded
    # weights) at 3.35 TB/s; the unpadded weights give a little less
    b = flops.k2_bound(F, 98_304)
    assert b.nbytes / 1e9 == pytest.approx(0.566, rel=0.01)
    assert b.nbytes / flops.PEAK_BYTES > b.flops / flops.PEAK_FLOPS["bf16"]


def test_backward_counts():
    # the backward needs every weight product and no transposed product
    # into the embedding; K3 also recomputes the coarse features
    w = F.width
    assert flops.backward_macs(F) == 2 * flops.field_macs(F, False) - 2 * 63 * w - 27 * w
    assert flops.k3_flops(F) - 2 * flops.backward_macs(F) == 2 * w * 3 * (w // 2)


def test_params_match_the_port():
    torch = pytest.importorskip("torch")
    from ibl_nerf_tpu_torch.models.aux_mlp import (init_position_direction_mlp,
                                                   init_position_mlp)
    from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
    from ibl_nerf_tpu_torch.train.step import _leaves

    rng = np.random.default_rng(0)
    field = init_field_params(rng, FieldConfig(), "cpu")
    assert sum(p.numel() for p in _leaves(field)) == flops.field_params(F)
    # the heads' multiply-adds per point are their weight counts
    for ch in (1, 3):
        pm = init_position_mlp(rng, 8, 256, 63, ch, device="cpu")
        weights = sum(layer["w"].numel() for layer in pm["trunk"]) + pm["out"]["w"].numel()
        assert flops.position_mlp_macs(8, 256, 63, ch) == weights
        assert sum(f * o for _, f, o in position_mlp_layers(ARGS, ch)) == weights
    pd = init_position_direction_mlp(rng, 8, 256, 63, 27, 1, device="cpu")
    weights = sum(p.numel() for p in _leaves(pd) if p.ndim == 2)
    assert flops.position_direction_mlp_macs(8, 256, 63, 27, 1) == weights
    assert sum(f * o for _, f, o in position_direction_mlp_layers(ARGS, 1)) == weights
    del torch


def test_update_work():
    args = dict(ARGS, compute_dtype="bf16_grad", N_samples=64, N_importance=128)
    work = flops.train_update_work(args, 4096)
    bf16 = sum(f for dt, f in work if dt == "bf16")
    f32 = sum(f for dt, f in work if dt == "f32")
    pts = 4096 * (64 + 192)
    assert bf16 == pts * (flops.k2_flops(F) + 2 * flops.backward_macs(F))
    assert f32 == 2 * 4096 * 64 * 2 * flops.field_macs(F, False)
    # ~17.6 ms at the data-sheet peaks
    assert flops.least_seconds(work) * 1e3 == pytest.approx(17.6, abs=0.3)
