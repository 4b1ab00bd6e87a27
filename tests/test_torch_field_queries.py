"""The renderer's field-query seam (`render/renderer.FieldQueries`) and its
one chunk loop, on the CPU (the kernels' plain versions), under the port's
default bf16_grad with K1 (`use_pallas`) and K2/K3 (`use_pallas_train`):

- a frame of three chunks from `make_frame_render_fn` + `render_frame`
  and from `render_image` equals `render_rays` called chunk by chunk
  without prepared queries, bit for bit, with gt normals, with ε normals
  and under Monte-Carlo shading;
- in such a frame `pack_field_weights` runs at most once per field and
  the eager cast at most once per field and dtype;
- `benchmark.trace.LaunchRecorder` over the renderer records one call
  per K1/K2 query with its points, over a frame of the benchmark's
  `split_sum.render_test` cell and over one update of each of its train
  cells (`benchmark/tests/tiny.py`'s size);
- one `loss_from_batch` with the depth-volume pass (`aux_heads.train4096`,
  whose inferred depth turns it on) builds a new
  `FieldQueries` for each of its passes (coarse, fine, and the
  depth-volume pass's two), so no bf16 cast carries the gradients of two
  passes.
"""

import math

import numpy as np
import pytest
import torch

from benchmark import trace
from benchmark.tests.tiny import run_of
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
from ibl_nerf_tpu_torch.models.field import FieldConfig, init_field_params
from ibl_nerf_tpu_torch.ops.rays import get_rays_full_image
from ibl_nerf_tpu_torch.render import (RenderConfig, make_frame_render_fn, make_ray_batch,
                                       render_frame, render_image, render_rays, renderer)

torch.set_num_threads(2)

H, W, CHUNK = 6, 8, 20   # 48 rays: three chunks, the last padded
NEAR, FAR = 2.0, 6.0
KERNELS = dict(compute_dtype="bf16_grad", use_pallas=True, use_pallas_train=True)
MODES = {
    "gt_normals": dict(normal_type="ground_truth"),
    "eps_normals": dict(normal_type="normal_map_from_depth_gradient_epsilon"),
    "monte_carlo": dict(normal_type="ground_truth", shading_mode="monte_carlo"),
}


@pytest.fixture(scope="module")
def frame():
    cfg = FieldConfig(depth=8, width=32, coarse_radiance_number=3)
    rng = np.random.default_rng(5)
    variables = {"coarse": init_field_params(rng, cfg, "cpu"),
                 "fine": init_field_params(rng, cfg, "cpu")}
    for v in variables.values():   # visible density
        v["sigma"]["b"] += 0.5
    gen = torch.Generator().manual_seed(3)
    normal = torch.nn.functional.normalize(torch.randn((H * W, 3), generator=gen), dim=-1)
    gt = {"normal": 0.5 * (normal + 1.0), "albedo": torch.rand((H * W, 3), generator=gen)}
    focal = 5.0
    K = torch.tensor([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    c2w = torch.eye(4)[:3]
    c2w[2, 3] = 4.0
    return {"variables": variables, "consts": {"brdf_lut": load_brdf_lut(device="cpu")},
            "gt": gt, "K": K, "c2w": c2w, "field": cfg}


def _rcfg(frame, mode: str, **kw) -> RenderConfig:
    return RenderConfig(field=frame["field"], n_samples=8, n_importance=8, perturb=False,
                        approximate_radiance=True, coarse_shading=False,
                        correct_depth_for_prefiltered_radiance_infer=True,
                        mc_samples_axis=2, **KERNELS, **MODES[mode], **kw)


@torch.no_grad()
def _by_chunks(frame, rcfg: RenderConfig) -> dict:
    """render_rays on one chunk after another, each pass building its own
    queries, merged to (H, W, C?)."""
    rays_o, rays_d = (r.reshape(-1, 3) for r in get_rays_full_image(H, W, frame["K"],
                                                                     frame["c2w"]))
    n, pad = H * W, (-H * W) % CHUNK

    def padded(x):
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])

    rays_o, rays_d = padded(rays_o), padded(rays_d)
    gt = {k: padded(v) for k, v in frame["gt"].items()}
    outs = [render_rays(frame["variables"], frame["consts"],
                        make_ray_batch(rays_o[s:s + CHUNK], rays_d[s:s + CHUNK], NEAR, FAR),
                        rcfg, gt_values={k: v[s:s + CHUNK] for k, v in gt.items()})
            for s in range(0, n + pad, CHUNK)]
    return {k: torch.cat([o[k] for o in outs])[:n].reshape(H, W, *outs[0][k].shape[1:])
            for k in outs[0]}


def _frame(frame, rcfg: RenderConfig) -> dict:
    rays_o, rays_d = get_rays_full_image(H, W, frame["K"], frame["c2w"])
    fn = make_frame_render_fn(frame["variables"], frame["consts"], rcfg)
    out = render_frame(fn, rays_o.reshape(-1, 3), rays_d.reshape(-1, 3), NEAR, FAR, CHUNK,
                       gt_values=frame["gt"])
    return {k: v.reshape(H, W, *v.shape[1:]) for k, v in out.items()}


def _image(frame, rcfg: RenderConfig) -> dict:
    return render_image(frame["variables"], frame["consts"], H, W, frame["K"], frame["c2w"],
                        NEAR, FAR, rcfg, gt_values=frame["gt"], chunk=CHUNK)


ENTRIES = {"render_frame": _frame, "render_image": _image}


@pytest.mark.parametrize("mode", list(MODES))
def test_frame_equals_render_rays_by_chunks(frame, mode):
    rcfg = _rcfg(frame, mode)
    ref = _by_chunks(frame, rcfg)
    assert "color_map" in ref and ref["color_map"].shape == (H, W, 3)
    for name, entry in ENTRIES.items():
        out = entry(frame, rcfg)
        assert out.keys() == ref.keys(), name
        for k in ref:
            assert torch.equal(out[k], ref[k]), (name, k)


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("mode", list(MODES))
def test_frame_prepares_each_field_once(frame, mode, entry, monkeypatch):
    """Packs counted by field, casts by field and dtype, over a frame of
    three chunks: a pack or a cast per chunk would count three."""
    packs, casts = {}, {}
    pack, cast = renderer.pack_field_weights, renderer.FieldQueries._cast

    def counted_pack(params, cfg, *args, **kwargs):
        key = id(params["sigma"]["w"])
        packs[key] = packs.get(key, 0) + 1
        return pack(params, cfg, *args, **kwargs)

    def counted_cast(self, dt):
        key = (id(self.params["sigma"]["w"]), dt)
        casts[key] = casts.get(key, 0) + 1
        return cast(self, dt)

    monkeypatch.setattr(renderer, "pack_field_weights", counted_pack)
    monkeypatch.setattr(renderer.FieldQueries, "_cast", counted_cast)
    ENTRIES[entry](frame, _rcfg(frame, mode))
    fine = id(frame["variables"]["fine"]["sigma"]["w"])
    coarse = id(frame["variables"]["coarse"]["sigma"]["w"])
    assert packs == {fine: 1}, packs   # K2's pack, which K1 reuses
    assert casts == {(coarse, torch.bfloat16): 1}, casts   # the coarse density pass


# --- the benchmark's launch recorder -----------------------------------------------

SEED = 2**33 + 5


@pytest.fixture(scope="module")
def render_cell():
    run, _ = run_of("split_sum.render_test", SEED, **KERNELS)
    return run


@pytest.fixture(scope="module")
def train_run():
    """The train cells' runs, each set up once for this module."""
    runs = {}

    def get(cell: str):
        if cell not in runs:
            runs[cell] = run_of(cell, SEED, **KERNELS)[0]
        return runs[cell]

    return get


def test_launch_recorder_over_a_frame(render_cell):
    """Each chunk's fine pass: one K2 query of its B(S+I) points (no K3:
    nothing follows it backward) and one K1 full query of the reflected
    march's B·S; gt normals take no K1 density query."""
    run, args = render_cell, render_cell.args
    rec = trace.LaunchRecorder(renderer)
    try:
        run.render()
    finally:
        calls = rec.close()
    b, s, i = args["chunk"], args["N_samples"], args["N_importance"]
    chunks = math.ceil(run.h * run.w / b)
    assert chunks > 1
    assert calls == {"k2": [b * (s + i)] * chunks, "k3": [],
                     "k1_full": [b * s] * chunks, "k1_density": []}


@pytest.mark.parametrize("cell", ["split_sum.train4096", "aux_heads.train4096"])
def test_launch_recorder_over_a_train_update(train_run, cell):
    """The coarse and the fine pass: K2 (and K3 after it) over B·S and
    B(S+I) points, each with a K1 full reflected march of B·S; the
    depth-volume pass (aux_heads) queries the eager density only."""
    run = train_run(cell)
    args = run.args
    rec = trace.LaunchRecorder(renderer)
    try:
        run.one()
    finally:
        calls = rec.close()
    b, s, i = args["N_rand"], args["N_samples"], args["N_importance"]
    assert run.volume == (cell == "aux_heads.train4096")
    assert calls == {"k2": [b * s, b * (s + i)], "k3": [b * s, b * (s + i)],
                     "k1_full": [b * s, b * s], "k1_density": []}


def test_loss_from_batch_builds_queries_per_pass(train_run, monkeypatch):
    """Four passes, four instances, each with its own pack or cast."""
    run = train_run("aux_heads.train4096")
    assert run.volume
    built, packs, casts = [], [], []
    init, pack, cast = (renderer.FieldQueries.__init__, renderer.pack_field_weights,
                        renderer.FieldQueries._cast)

    def counted_init(self, *args, **kwargs):
        built.append(self)
        init(self, *args, **kwargs)

    def counted_pack(params, cfg, *args, **kwargs):
        packs.append(id(params["sigma"]["w"]))
        return pack(params, cfg, *args, **kwargs)

    def counted_cast(self, dt):
        casts.append((id(self), dt))
        return cast(self, dt)

    monkeypatch.setattr(renderer.FieldQueries, "__init__", counted_init)
    monkeypatch.setattr(renderer, "pack_field_weights", counted_pack)
    monkeypatch.setattr(renderer.FieldQueries, "_cast", counted_cast)
    run.one()
    variables = run.state.variables
    assert [q.params is variables[f] for q, f in zip(built, ("coarse", "fine") * 2)] == [True] * 4
    assert len({id(q) for q in built}) == 4 and all(q.grad and q.k2 for q in built)
    # K2's f32 pack in the shaded coarse and fine passes (K1 reuses it),
    # the bf16 density cast in each of the depth-volume pass's two
    assert packs == [id(variables[f]["sigma"]["w"]) for f in ("coarse", "fine")]
    assert casts == [(id(q), torch.bfloat16) for q in built[2:]]
