"""ibl_nerf_tpu_torch.ops against ibl_nerf_tpu.ops on the same inputs.

Inputs come from numpy seeds; random draws come from jax.random and are
handed to the port as `u`. Tolerances: 1e-6 where both sides do the same
f32 arithmetic in the same order, 1e-5 where a reduction or a
transcendental may round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.ops import color as jcolor
from ibl_nerf_tpu.ops import compositing as jcomp
from ibl_nerf_tpu.ops import embedding as jemb
from ibl_nerf_tpu.ops import geometry as jgeo
from ibl_nerf_tpu.ops import rays as jrays
from ibl_nerf_tpu.ops import sampling as jsamp
from ibl_nerf_tpu.ops import shading as jshade
from ibl_nerf_tpu.ops import texture as jtex
from ibl_nerf_tpu_torch.ops import color as tcolor
from ibl_nerf_tpu_torch.ops import compositing as tcomp
from ibl_nerf_tpu_torch.ops import embedding as temb
from ibl_nerf_tpu_torch.ops import geometry as tgeo
from ibl_nerf_tpu_torch.ops import rays as trays
from ibl_nerf_tpu_torch.ops import sampling as tsamp
from ibl_nerf_tpu_torch.ops import shading as tshade
from ibl_nerf_tpu_torch.ops import texture as ttex

torch.set_num_threads(2)


def T(x):
    return torch.from_numpy(np.array(x))


def close(port, ref, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("multires", [0, 4, 10])
def test_positional_encoding(multires):
    x = np.random.default_rng(0).uniform(-2, 2, (5, 7, 3)).astype(np.float32)
    assert temb.embedding_dim(3, multires) == jemb.embedding_dim(3, multires)
    np.testing.assert_array_equal(temb.frequency_bands(multires),
                                  jemb.frequency_bands(multires))
    close(temb.positional_encoding(T(x), multires),
          jemb.positional_encoding(jnp.asarray(x), multires), atol=1e-5)


def test_compositing():
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(2, 6, (6, 12)), -1).astype(np.float32)
    rd = rng.standard_normal((6, 3)).astype(np.float32)
    sig = rng.standard_normal((6, 12)).astype(np.float32) * 3
    vals = rng.uniform(0, 1, (6, 12, 3)).astype(np.float32)

    d_t, d_j = tcomp.dists_from_z_vals(T(z), T(rd)), jcomp.dists_from_z_vals(z, rd)
    close(d_t, d_j, rtol=1e-6)
    a_t, a_j = tcomp.alpha_from_sigma(T(sig), d_t), jcomp.alpha_from_sigma(sig, d_j)
    close(a_t, a_j, atol=1e-6)
    w_t, w_j = tcomp.weights_from_alpha(a_t), jcomp.weights_from_alpha(a_j)
    close(w_t, w_j, atol=1e-6)
    (w2_t, v_t), (w2_j, v_j) = (tcomp.transmittance_and_weights(a_t),
                                jcomp.transmittance_and_weights(a_j))
    close(w2_t, w2_j, atol=1e-6)
    close(v_t, v_j, atol=1e-6)
    close(tcomp.accumulate(w_t, T(vals)), jcomp.accumulate(w_j, vals), atol=1e-6)
    close(tcomp.accumulate(w_t, T(vals[..., 0])),
          jcomp.accumulate(w_j, vals[..., 0]), atol=1e-6)
    for p, r in zip(tcomp.composite_depth_disp_acc(w_t, T(z)),
                    jcomp.composite_depth_disp_acc(w_j, z)):
        close(p, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("perturb", [False, True])
def test_stratified_z_vals(lindisp, perturb):
    rng = np.random.default_rng(2)
    near = rng.uniform(0.5, 2, (5, 1)).astype(np.float32)
    far = near + rng.uniform(1, 4, (5, 1)).astype(np.float32)
    key = jax.random.key(3)
    ref = jsamp.stratified_z_vals(key, near, far, 16, lindisp=lindisp,
                                  perturb=perturb)
    u = T(jax.random.uniform(key, (5, 16), dtype=jnp.float32)) if perturb else None
    out = tsamp.stratified_z_vals(T(near), T(far), 16, lindisp=lindisp,
                                  perturb=perturb, u=u)
    close(out, ref, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf(det):
    rng = np.random.default_rng(4)
    bins = np.sort(rng.uniform(2, 6, (7, 15)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (7, 14)).astype(np.float32)
    w[0] = 0.0          # degenerate rows exercise the denom guard
    w[1, :10] = 0.0
    key = jax.random.key(5)
    ref = jsamp.sample_pdf(key, bins, w, 33, det=det)
    u = None if det else T(jax.random.uniform(key, (7, 33), dtype=jnp.float32))
    out = tsamp.sample_pdf(T(bins), T(w), 33, det=det, u=u)
    close(out, ref, atol=1e-5, rtol=1e-6)


def test_sampling_needs_draws():
    z = torch.ones(2, 1)
    with pytest.raises(ValueError):
        tsamp.stratified_z_vals(z, 2 * z, 4, perturb=True)
    with pytest.raises(ValueError):
        tsamp.sample_pdf(torch.ones(2, 5), torch.ones(2, 4), 4, det=False)


def _camera(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[30.0, 0, 4.0], [0, 30.0, 3.0], [0, 0, 1]], np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.concatenate([q, rng.standard_normal((3, 1))], 1).astype(np.float32)
    return K, c2w


def test_rays():
    K, c2w = _camera(6)
    for p, r in zip(trays.get_rays_full_image(6, 8, T(K), T(c2w)),
                    jrays.get_rays_full_image(6, 8, K, c2w)):
        close(p, r, atol=1e-6)
    uv = np.random.default_rng(7).uniform(0, 8, (11, 2)).astype(np.float32)
    for p, r in zip(trays.get_rays_for_pixels(T(uv), T(K), T(c2w)),
                    jrays.get_rays_for_pixels(uv, K, c2w)):
        close(p, r, atol=1e-6)


def test_grid_sample_2d():
    rng = np.random.default_rng(8)
    tex = rng.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (40, 2)).astype(np.float32)
    uv[:4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    close(ttex.grid_sample_2d(T(tex), T(uv)), jtex.grid_sample_2d(tex, uv),
          atol=1e-6)


def test_mip_interp():
    rng = np.random.default_rng(9)
    levels = rng.uniform(0, 1, (20, 4, 3)).astype(np.float32)
    lv = rng.uniform(-0.1, 1.1, (20,)).astype(np.float32)
    lv[:3] = [0.0, 1.0, 0.5]
    close(ttex.mip_interp(T(levels), T(lv)), jtex.mip_interp(levels, lv),
          atol=1e-6)


def test_shading():
    rng = np.random.default_rng(10)
    cos = rng.uniform(-0.2, 1.2, (9,)).astype(np.float32)
    f0 = rng.uniform(0, 1, (9, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, (9,)).astype(np.float32)
    close(tshade.fresnel_schlick_roughness(T(cos), T(f0), T(rough)),
          jshade.fresnel_schlick_roughness(cos, f0, rough), atol=1e-6)
    d = rng.standard_normal((9, 3)).astype(np.float32)
    n = rng.standard_normal((9, 3)).astype(np.float32)
    close(tshade.reflect(T(d), T(n)), jshade.reflect(d, n), atol=1e-5)


def test_color():
    x = np.random.default_rng(11).uniform(0, 2, (6, 3)).astype(np.float32)
    close(tcolor.rgb_to_srgb(T(x)), jcolor.rgb_to_srgb(x), atol=1e-6)
    close(tcolor.tonemap_reinhard(T(x)), jcolor.tonemap_reinhard(x), atol=1e-6)
    np.testing.assert_array_equal(tcolor.to8b(x), jcolor.to8b(x))


def test_geometry():
    K, c2w = _camera(12)
    depth = np.random.default_rng(13).uniform(2, 4, (6, 8)).astype(np.float32)
    close(tgeo.depth_to_position(6, 8, T(K), T(c2w), T(depth)),
          jgeo.depth_to_position(6, 8, K, c2w, depth), atol=1e-5)
    close(tgeo.depth_to_normal_image_space(T(depth), T(c2w), T(K)),
          jgeo.depth_to_normal_image_space(depth, c2w, K), atol=1e-4)
