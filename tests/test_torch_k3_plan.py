"""K3's launch plan, pure Python: the point ranges, the dW tile jobs with
their bias sums, and the slab layout of the reverse chain's weights.

The CUDA kernels run only on the card (chip_smoke.py holds them against
`train_backward_plain`); these tests check on the CPU that the tables
they are handed cover every point and every gradient element exactly
once, and that executing the plan as the kernels do gives the plain
version's gradients.
"""

import numpy as np
import pytest
import torch

from ibl_nerf_tpu_torch.kernels import fused_field_train as fft

torch.set_num_threads(2)

N_OUT, VF = 18, 384   # 9 + 3K and K * 128 at K = 3
SIZES = [1, 63, 64, 65, 4096, 4097, 98341]


# the packed weights' shapes at 8x256, K = 3 (pack_field_weights)
_ODD = {"w0": (128, 256), "w5x": (128, 256), "wv_d": (128, 256), "tb": (8, 256),
        "wcf": (256, VF), "A": (256, N_OUT), "B": (256, N_OUT), "C": (256, N_OUT),
        "D": (VF, N_OUT), "bcf": (VF,), "bias": (N_OUT,), "bpf": (256,), "bfeat": (256,),
        "bv": (256,)}
SHAPES = tuple((k, _ODD.get(k, (256, 256))) for k in fft._DW_ORDER)


def _elements(job):
    """Flat gradient indices a job writes: its dW tile and its bias sums."""
    rows = range(job.m0, min(job.m0 + fft.DW_TILE, job.m))
    cols = range(job.n0, min(job.n0 + job.cols, job.n))
    out = [job.out + r * job.n + c for r in rows for c in cols]
    if job.sum_src:
        out += [job.sum_out + c - job.n0 for c in cols]
    return out


def _unslab(slabs, shapes):
    """The inverse of `chain_slabs`: each summand's B = [n][k]."""
    sched, _ = fft.chain_schedule(shapes)
    out = {}
    for w, t, n, k, first, stride in sched:
        passes, ks = -(-n // fft.SLAB_N), -(-k // fft.SLAB_K)
        idx = [first + p * stride + s for p in range(passes) for s in range(ks)]
        blocks = slabs[idx].reshape(passes, ks, fft.SLAB_N, fft.SLAB_K)
        out[(w, t)] = blocks.permute(0, 2, 1, 3).reshape(
            passes * fft.SLAB_N, ks * fft.SLAB_K)[:n, :k]
    return out


@pytest.mark.parametrize("n", SIZES)
def test_ranges_cover_the_points_once_in_order(n):
    plan = fft.k3_plan(n, SHAPES)
    assert len(plan.ranges) == fft.dw_splits(n)
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == n
    for (b0, e0), (b1, _) in zip(plan.ranges, plan.ranges[1:]):
        assert e0 == b1   # contiguous, in order, no overlap
    for r, (b, e) in enumerate(plan.ranges):
        # what the kernel computes from blockIdx.y and chunk
        assert (b, e) == (min(n, r * plan.chunk), min(n, r * plan.chunk + plan.chunk))
        assert 0 <= e - b <= plan.chunk
    assert plan.chunk % fft.DW_POINTS == 0 and plan.chunk * len(plan.ranges) >= n


@pytest.mark.parametrize("n", SIZES)
def test_every_gradient_element_is_written_once_per_range(n):
    """Each range runs every job into its own partial; so per range each
    element of the 24 flat gradients (dW tiles and bias sums alike) must
    come from exactly one job, and bias sums share the dW ranges."""
    plan = fft.k3_plan(n, SHAPES)
    hits = np.zeros(plan.total, np.int64)
    for job in plan.jobs:
        np.add.at(hits, _elements(job), 1)
    assert (hits == 1).all()
    offs = dict(plan.offsets)
    for job in plan.jobs:   # each tile stays inside its own gradient
        size = int(np.prod(dict(SHAPES)[job.weight]))
        assert offs[job.weight] == job.out and job.out + size <= plan.total
    sums = [j for j in plan.jobs if j.sum_src]
    assert {j.delta for j in sums} == {("g16" if dl == "g" else dl) for _, _, dl in fft._DW_SUMS}
    assert all(j.m0 == 0 for j in sums)
    assert [j.sum_src for j in sums].count(2) == 1   # the output bias, from the f32 g


def test_job_table_matches_the_jobs():
    plan = fft.k3_plan(4097, SHAPES)
    table = np.array(plan.table[:], np.int64).reshape(-1, 11)
    cols = fft.plane_cols(dict(SHAPES))
    assert len(plan.jobs) <= 64   # kMaxJobs of the kernel
    for row, job in zip(table, plan.jobs):
        act, delta = fft._PLANES[row[0]], fft._PLANES[row[1]]
        assert (act, delta, row[2], row[3]) == (job.act, job.delta, cols[act], cols[delta])
        assert tuple(row[4:]) == (job.m0, job.n0, job.m, job.n, job.out, job.sum_out,
                                  job.sum_src)
        assert cols[delta] % 8 == 0 and job.n <= cols[delta] and job.m <= cols[act]
    assert fft.k3_plan(4097, SHAPES) is plan   # a function of n and the shapes alone


@pytest.mark.parametrize("n", SIZES[:-1])
def test_executing_the_plan_gives_the_plain_gradients(n):
    """Run the plan as the kernels do -- per range, each job's tile and
    bias sums into that range's partial, then the partials summed in
    range order -- on random planes, against `dw_from_deltas_plain`."""
    rng = np.random.default_rng(n)
    cols = fft.plane_cols(dict(SHAPES))
    planes = {k: rng.standard_normal((n, c)).astype(np.float32) for k, c in cols.items()}
    planes["g16"][:, N_OUT:] = 0.0   # the chain writes g16 zero past 9+3K
    g = rng.standard_normal((n, N_OUT)).astype(np.float32)
    plan = fft.k3_plan(n, SHAPES)

    partial = np.zeros((len(plan.ranges), plan.total))
    for r, (b, e) in enumerate(plan.ranges):
        for job in plan.jobs:
            rows = slice(job.m0, min(job.m0 + fft.DW_TILE, job.m))
            cs = slice(job.n0, min(job.n0 + job.cols, job.n))
            a = planes[job.act][b:e, rows].astype(np.float64)
            d = planes[job.delta][b:e, cs].astype(np.float64)
            tile = a.T @ d
            for i, row in enumerate(range(rows.start, rows.stop)):
                at = job.out + row * job.n + cs.start
                partial[r, at:at + tile.shape[1]] = tile[i]
            if job.sum_src:
                src = g[b:e, cs] if job.sum_src == 2 else d
                partial[r, job.sum_out:job.sum_out + tile.shape[1]] = src.sum(0)
    flat = partial.sum(0)

    res = torch.from_numpy(np.stack([planes[k] for k in fft._RES_ORDER]))
    deltas = {k: torch.from_numpy(planes[k]) for k in fft._DELTA_ORDER}
    deltas["g16"] = deltas["g16"][:, :N_OUT]
    want = fft.dw_from_deltas_plain(deltas, res, torch.from_numpy(g))
    for k, off in plan.offsets:
        got = flat[off:off + want[k].numel()].reshape(want[k].shape)
        np.testing.assert_allclose(got, want[k].double().numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.sqrt(n)))


def test_slab_layout_round_trips():
    rng = np.random.default_rng(0)
    w16 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
           for k, s in SHAPES}
    slabs = fft.chain_slabs(w16)
    sched, total = fft.chain_schedule(SHAPES)
    assert slabs.shape == (total, fft.SLAB_N, fft.SLAB_K)

    def passes(c):
        return -(-c // fft.SLAB_N)

    def ks(k):
        return -(-k // fft.SLAB_K)

    # the count the kernel checks (chain_slab_count): vf and dvf, then dhv,
    # dft, dpf, d7 and d6..d0, g16's operands padded to one k-slab
    assert total == passes(VF) * (ks(256) + ks(32)) + passes(256) * (
        ks(32) + ks(VF) + ks(256) + ks(32) + ks(32) + 2 * ks(256) + 7 * ks(256))
    back = _unslab(slabs, SHAPES)
    for w, t, *_ in sched:
        assert torch.equal(back[(w, t)], w16[w].t() if t else w16[w])
    # nothing but the weights: every other element is padding, zero
    assert int((slabs != 0).sum()) == int(sum((w16[w] != 0).sum() for w, *_ in sched))


def test_slab_schedule_tiles_the_stream():
    """Every slab of the stream belongs to exactly one (summand, pass,
    k-slab), and a layer's passes hold its summands' k-slabs in order."""
    sched, total = fft.chain_schedule(SHAPES)
    owner = np.zeros(total, np.int64)
    for w, t, n, k, first, stride in sched:
        for p in range(-(-n // fft.SLAB_N)):
            for s in range(-(-k // fft.SLAB_K)):
                owner[first + p * stride + s] += 1
    assert (owner == 1).all()
    assert [w for w, *_ in sched] == [w for layer in fft._CHAIN_LAYERS for w, _ in layer]
