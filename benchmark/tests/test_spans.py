"""The span sub-window's reduction on synthetic events (in the style of
`test_trace_reduction`), its readers, a CPU sub-window of a small run, and
on the card that the traced sub-window holds no span while this one does."""

import pytest
import torch

from benchmark import spans, trace
from benchmark.spans import Event

W = trace.WINDOW


def ann(name, s, e, device=False):
    return Event(name, s, e, device, 1, 0, 0, annotation=True)


def events(units=1):
    """One update in [0, 100] us on thread 1 (the autograd engine's thread
    is 2): the aux heads (depth 3) launch an sgemm whose backward node's
    sgemm runs in the backward; Adam launches one op; one copy names no
    launch. Each range also has its device-side annotation."""
    out = [ann(W, 0, 100), ann(W, 0, 100, True)]
    for i in range(units):
        o = 100.0 * i
        out += [ann(n, o + s, o + e) for n, s, e in [
            ("train.update", 0, 100), ("train.forward", 5, 40), ("render.fine", 10, 30),
            ("render.aux_heads", 12, 20), ("train.backward", 45, 80),
            ("train.optimizer", 82, 95)]]
        out += [ann("train.update", o + 1, o + 99, True), ann("render.fine", o + 11, o + 29, True)]
        out += [
            Event("aten::mm", o + 13, o + 16, False, 1, 50 + i, 0, seq=7 + i),
            Event("cudaLaunchKernel", o + 14, o + 15, False, 1, 101 + 10 * i, 50 + i),
            Event("sgemm", o + 16, o + 26, True, 7, 101 + 10 * i, 50 + i),
            Event("autograd::engine::evaluate_function: MmBackward0", o + 50, o + 60, False, 2,
                  60 + i, 0, seq=7 + i, fwd_thread=1),
            Event("cudaLaunchKernel", o + 52, o + 53, False, 2, 102 + 10 * i, 61 + i),
            Event("sgemm_bwd", o + 55, o + 65, True, 7, 102 + 10 * i, 61 + i),
            Event("cudaMemcpyAsync", o + 69, o + 70, False, 1, 104 + 10 * i, 0),
            Event("memcpy", o + 70, o + 72, True, 7, 999, 0),
            Event("cudaLaunchKernel", o + 85, o + 86, False, 1, 103 + 10 * i, 0),
            Event("foreach_add", o + 86, o + 90, True, 7, 103 + 10 * i, 0)]
    if units > 1:
        out = [e for e in out if e.name != W]
        out += [ann(W, 0, 100 * units), ann(W, 0, 100 * units, True)]
    return out


def test_annotations_stay_out_of_the_busy_set():
    r = spans.reduce(events(), 1)
    assert r["root"] == "train.update" and r["units"] == 1
    assert r["window_ms"] == pytest.approx(0.1)
    assert r["busy_ms"] == pytest.approx(0.026)     # 16-26, 55-65, 70-72, 86-90
    assert r["idle_ms"] == pytest.approx(0.074)
    assert r["unlinked_ops"] == 1                   # the copy: no runtime call of id 999


def test_idle_split_adds_up():
    r = spans.reduce(events(), 1)
    idle = {n: r["spans"][n]["idle_ms"][0] for n in spans.ROOTS["train.update"]}
    assert idle == pytest.approx({"train.forward": 0.025, "train.backward": 0.023,
                                  "train.optimizer": 0.009})
    assert r["outside_idle_ms"] == pytest.approx(0.017)   # 0-5, 40-45, 80-82, 95-100
    assert sum(idle.values()) + r["outside_idle_ms"] == pytest.approx(r["idle_ms"])
    assert r["spans"][spans.CHILDREN]["idle_ms"][0] == pytest.approx(sum(idle.values()))
    assert r["busy_under_children"] == pytest.approx(24 / 26)
    assert r["spans"]["train.update"]["host_ms"] == [pytest.approx(0.1)]


def test_kernel_belongs_to_enclosing_spans_at_any_depth():
    r = spans.reduce(events(), 1)["spans"]
    for name in ("render.aux_heads", "render.fine", "train.forward", "train.update"):
        assert r[name]["device_ops"][0] >= 1, name
    assert r["train.optimizer"]["device_ms"] == [pytest.approx(0.004)]
    assert r["train.optimizer"]["device_ops"] == [1]


def test_backward_kernel_belongs_to_its_forward_ops_spans():
    r = spans.reduce(events(), 1)["spans"]
    # sgemm (forward) and sgemm_bwd, through MmBackward0's (7, thread 1)
    assert r["render.aux_heads"]["device_ms"] == [pytest.approx(0.020)]
    assert r["+aux_heads"]["device_ms"] == [pytest.approx(0.020)]
    assert r["train.backward"]["device_ms"] == [pytest.approx(0.010)]
    assert r["train.update"]["device_ms"] == [pytest.approx(0.024)]


def test_units_split_and_must_match():
    r = spans.reduce(events(units=2), 2)
    assert r["spans"]["render.aux_heads"]["device_ms"] == [pytest.approx(0.02)] * 2
    assert r["spans"]["train.forward"]["idle_ms"] == [pytest.approx(0.025)] * 2
    with pytest.raises(ValueError, match="2 train.update spans"):
        spans.reduce(events(units=2), 3)


@pytest.mark.parametrize("metric", sorted(spans.METRICS))
def test_readers_return_none_where_their_spans_did_not_run(metric):
    assert spans.read({}, metric) is None
    assert spans.read({"spans": None}, metric) is None
    assert spans.reduce([ann(W, 0, 10), Event("k", 1, 2, True, 7, 1, 0)], 1) is None
    train = spans.reduce(events(), 1)
    value = spans.read({"spans": train}, metric)
    if metric.endswith(".render"):
        assert value is None
    else:
        expected = {"idle.forward.train": 25.0, "idle.backward.train": 23.0,
                    "idle.optimizer.train": 9.0, "device_ms.aux_heads.train": 0.02}[metric]
        assert value == pytest.approx(expected)


def test_metrics_name_the_benchmarks_layers():
    from benchmark import harness

    layers = {m["layer"] for m in harness.read_json(harness.REPO / "BENCHMARK.json")[
        "per_layer"]}
    for unit, layer, moves, kind, entry in spans.METRICS.values():
        assert layer in layers and kind in ("idle", "device_ms")
        assert moves in ("train_rays_per_s", "render_rays_per_s")


@pytest.mark.parametrize("cell", ["split_sum.train4096", "aux_heads.train4096"])
def test_cpu_sub_window_of_a_small_run(cell):
    from tiny import run_of

    run, _ = run_of(cell, 5)
    r = spans.profile(lambda: [run.one() for _ in range(2)], 2)
    assert r["root"] == "train.update" and r["busy_ms"] == 0.0
    for child in spans.ROOTS["train.update"]:
        assert len(r["spans"][child]["host_ms"]) == 2 and all(r["spans"][child]["host_ms"])
    assert r["idle_ms"] == pytest.approx(r["window_ms"])
    assert ("train.depth_volume" in r["spans"]) == (cell == "aux_heads.train4096")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["split_sum.train4096", "split_sum.render_test"])
def test_spans_stay_out_of_the_traced_sub_window(cell, cuda_device):
    """Small runs on the card: the traced sub-window's profile (trace.profile's
    activities, spans off) holds no annotation but the window's; the span
    sub-window's holds a root for every unit and device-typed annotations,
    and links every device op to its launch."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from benchmark import harness
    from tiny import ARGS, SCENE, TRAFFIC

    wl = harness.read_json(harness.BENCH / "workloads" / f"{cell}.json")
    cfg = harness.read_json(harness.BENCH / "configs" / f"{wl['config']}.json")
    config = dict(cfg, args={**cfg["args"], **ARGS}, scene={**cfg["scene"], **SCENE})
    driver = harness.load_module(harness.BENCH / "traffic" / f"{wl['traffic']['kind']}.py")
    run = driver.Run(config, {**wl["traffic"], **TRAFFIC}, 2**32 + 19, cuda_device,
                     harness.Phases(time.perf_counter()))
    unit, root = (run.one, "train.update") if hasattr(run, "one") else (
        run.render, "render_path.frame")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            unit()
            unit()
            torch.cuda.synchronize()
    assert {e.name for e in spans.events_of(prof) if e.annotation} == {W}
    assert trace.profile(lambda: [unit() for _ in range(2)], 2)["device_ops"] > 0
    events = spans.record(lambda: [unit() for _ in range(2)])
    assert sum(e.name == root and e.annotation and not e.device for e in events) == 2
    # each range that launched a kernel is also a device-typed annotation,
    # which trace.reduce would count as busy time and as device ops
    assert any(e.device and e.annotation and e.name != W for e in events)
    r = spans.reduce(events, 2)
    assert r["unlinked_ops"] == 0 and r["busy_under_children"] > 0.95
