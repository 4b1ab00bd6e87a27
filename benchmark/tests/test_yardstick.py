"""The rest of the yardstick on the CPU: BENCHMARK.json against the files
it names, the trace's reduction, the render comparison's set-aside, and
the per-layer readers."""

import json
import math

import pytest
import torch

from benchmark import harness, readers, trace
from benchmark.traffic.render_frames import SET_ASIDE, rel_gap
from benchmark.traffic.train_updates import compare

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())


def test_benchmark_names_its_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        cfg = harness.read_json(harness.REPO / c["file"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for name, w in cells.items():
        wl = harness.read_json(harness.BENCH / "workloads" / f"{name}.json")
        assert (wl["config"], wl["traffic"]["name"], wl["chips"], wl["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert (harness.BENCH / "traffic" / f"{wl['traffic']['kind']}.py").exists()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        mod = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
        assert (mod.LAYER, mod.MOVES, mod.UNIT) == (m["layer"], m["moves"], m["unit"])
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = harness.cell_metrics(BENCH, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.cell_metrics(BENCH, cell, "per_layer")


def test_trace_reduction():
    W = trace.WINDOW
    events = [(W, 0.0, 100.0, False, 1), (W, 0.0, 100.0, True, 0),
              ("k2_forward", 10.0, 30.0, True, 0), ("k3_delta_chain", 25.0, 50.0, True, 0),
              ("fill", 70.0, 80.0, True, 0), ("aten::cat", 52.0, 68.0, False, 1),
              ("step", 0.0, 100.0, False, 1)]
    r = trace.reduce(events, units=2)
    assert r["busy_s"] == pytest.approx(50e-6)     # [10, 50] and [70, 80]
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["device_ops"] == 3
    assert r["breakdown"]["idle_gaps"][0] == ["aten::cat", pytest.approx(20e-6)]
    assert r["breakdown"]["device_ops"][0] == ["k3_delta_chain", pytest.approx(25e-6)]
    ctx = {"trace": r, "window": {"units": 2, "seconds": 1.0, "least_unit_s": 0.1}}
    assert readers.idle(ctx) == pytest.approx(50.0)
    assert readers.device_ops_per_unit(ctx) == 1.5
    assert readers.mfu(ctx) == pytest.approx(20.0)


def test_roofline_needs_agreeing_counts():
    f_args = {"netwidth": 256, "multires": 10, "multires_views": 4, "coarse_radiance_number": 3}
    ctx = {"args": f_args, "launches": {"k2": [98_304], "k3": [], "k1_full": [], "k1_density": []},
           "counters": {"fused_field_train_fwd": 1},
           "trace": {"kernel_s": {"(anonymous namespace)::k2_forward(float const*)": 0.338e-3,
                                  "kernel2_other": 1.0}}}
    assert readers.roofline(ctx, "k2") == pytest.approx(50.0, rel=0.01)
    ctx["counters"]["fused_field_train_fwd"] = 2
    assert readers.roofline(ctx, "k2") is None
    assert readers.roofline(ctx, "k1") is None


def test_render_gap_sets_aside_flips_only():
    g = torch.Generator().manual_seed(0)
    ref = torch.rand((4096, 3), generator=g)
    prog = ref + 1e-6 * torch.randn((4096, 3), generator=g)
    flips = torch.randperm(4096, generator=g)[:int(SET_ASIDE * 4096)]
    prog[flips] += 0.5
    assert rel_gap(prog, ref) < 1e-5
    chunk = prog.clone()
    chunk[:27] += 0.1      # a wrong chunk: 0.67% of a frame's pixels
    assert rel_gap(chunk, ref) > 1e-3
    nan = torch.full((4096,), math.nan)
    assert rel_gap(nan, nan) == 0.0
    one_side = ref[:, 0].clone()
    one_side[:100] = math.nan
    assert rel_gap(one_side, ref[:, 0]) == math.inf


def test_train_compare():
    ref = {"losses": [2.0, 1.0], "first_grad": {"a": 1.0, "b": 2.0, "c": 1e-6, "d": 0.0},
           "change": {"a": 1.0, "b": 1.0, "c": 5.0, "d": 0.0}}
    prog = {"losses": [2.0, 1.1], "first_grad": {"a": 1.1, "b": 2.0, "c": 1.0, "d": 0.0},
            "change": {"a": 1.0, "b": 0.5, "c": 0.0, "d": 3.0}}
    out = compare(prog, ref)
    assert out["loss"] == pytest.approx(0.1)
    assert out["first_grad"] == pytest.approx(0.1 / 1.5)   # c and d are not compared
    assert out["change"] == pytest.approx(0.5)
    assert out["change_median"] == pytest.approx(0.25)
