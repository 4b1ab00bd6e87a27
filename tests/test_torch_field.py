"""ibl_nerf_tpu_torch.models.field and utils.port against the JAX field.

Weights come from JAX `init_field_params` and reach the port through
`field_params_from_numpy`. f32 tolerance atol 2e-5 / rtol 1e-4 (the
kernel tests' bound): matmuls sum in another order on each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibl_nerf_tpu.models import field as jfield
from ibl_nerf_tpu.ops.embedding import positional_encoding as jpe
from ibl_nerf_tpu.utils import port as jport
from ibl_nerf_tpu_torch.models import field as tfield
from ibl_nerf_tpu_torch.utils import port as tport

torch.set_num_threads(2)


def _cfgs(depth, width, k):
    kw = dict(depth=depth, width=width, coarse_radiance_number=k)
    return jfield.FieldConfig(**kw), tfield.FieldConfig(**kw)


def _inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (6, 9, 3)).astype(np.float32)
    dirs = rng.standard_normal((6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pe = np.array(jpe(jnp.asarray(pts), jcfg.multires))
    de = np.array(jpe(jnp.asarray(dirs), jcfg.multires_views))
    de = np.broadcast_to(de[:, None, :], (*pts.shape[:-1], de.shape[-1])).copy()
    return pe, de


def _params(jcfg, seed=0):
    jp = jax.jit(jfield.init_field_params, static_argnums=1)(jax.random.key(seed), jcfg)
    return jp, tport.field_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("depth,width,k", [(8, 32, 3), (2, 16, 0), (8, 256, 3)])
def test_apply_field_f32(depth, width, k):
    jcfg, tcfg = _cfgs(depth, width, k)
    jp, tp = _params(jcfg)
    pe, de = _inputs(jcfg)
    ref = jax.jit(jfield.apply_field, static_argnums=3)(jp, pe, de, jcfg)
    out = tfield.apply_field(tp, torch.from_numpy(pe), torch.from_numpy(de), tcfg)
    assert out.shape == ref.shape == (6, 9, tfield.field_raw_channels(tcfg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    dens = tfield.apply_field_density(tp, torch.from_numpy(pe), tcfg)
    np.testing.assert_allclose(dens.numpy(),
                               np.asarray(jax.jit(jfield.apply_field_density,
                                                  static_argnums=2)(jp, pe, jcfg)),
                               atol=2e-5, rtol=1e-4)
    # the density query shares trunk + sigma with the full one
    np.testing.assert_allclose(dens.numpy(), out[..., :1].numpy(), atol=1e-5)


def test_apply_field_bf16_operands():
    """bf16 params and embeddings, f32 raw heads (`_mm_f32out`). bf16
    keeps 8 mantissa bits and the two frameworks round the bf16 hidden
    activations at the same points but may sum in another order, so a
    hidden unit can land one bf16 ulp (2^-8 relative) apart; through the
    heads that is a few 1e-3 on outputs of size ~0.3."""
    jcfg, tcfg = _cfgs(8, 32, 3)
    jp, tp = _params(jcfg)
    pe, de = _inputs(jcfg)
    jb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    ref = jax.jit(jfield.apply_field, static_argnums=3)(
        jb, jnp.asarray(pe, jnp.bfloat16), jnp.asarray(de, jnp.bfloat16), jcfg)
    tb = jax.tree.map(lambda x: x.to(torch.bfloat16), tp)
    out = tfield.apply_field(tb, torch.from_numpy(pe).bfloat16(),
                             torch.from_numpy(de).bfloat16(), tcfg)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-2, rtol=2e-2)


def test_init_field_params_structure_and_bounds():
    jcfg, tcfg = _cfgs(8, 32, 3)
    jp = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.key(0), jcfg))
    tp = tfield.init_field_params(np.random.default_rng(0), tcfg, device="cpu")
    j_leaves, j_def = jax.tree.flatten(jp)
    t_leaves, t_def = jax.tree.flatten(tp)
    assert j_def == t_def
    for j, t in zip(j_leaves, t_leaves):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    for layer in tp["trunk"] + [tp["sigma"], tp["views"][0]]:
        bound = 1.0 / np.sqrt(layer["w"].shape[0])
        for v in (layer["w"], layer["b"]):
            assert float(v.abs().max()) <= bound
    again = tfield.init_field_params(np.random.default_rng(0), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(t_leaves, jax.tree.flatten(again)[0]))


def test_params_from_numpy_round_trip():
    jcfg, _ = _cfgs(2, 16, 2)
    jp = jax.tree.map(np.asarray, jfield.init_field_params(jax.random.key(4), jcfg))
    tp = tport.field_params_from_numpy(jp, "cpu")
    for j, t in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_array_equal(t.numpy(), j)


def test_field_params_from_torch_state():
    rng = np.random.default_rng(5)
    names = ([f"positions_linears.{i}" for i in range(8)]
             + ["sigma_linear", "albedo_feature_linear", "albedo_linear",
                "roughness_linear", "irradiance_feature_linear",
                "irradiance_linear", "feature_linear", "views_linears.0",
                "radiance_linear"]
             + [f"additional_radiance_feature_linear.{i}" for i in range(3)]
             + [f"additional_radiance_linear.{i}" for i in range(3)])
    sd = {}
    for n in names:
        sd[f"{n}.weight"] = rng.standard_normal((4, 5)).astype(np.float32)
        sd[f"{n}.bias"] = rng.standard_normal((4,)).astype(np.float32)
    ref = jax.tree.map(np.asarray, jport.field_params_from_torch_state(sd))
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    out = tport.field_params_from_torch_state(tsd, device="cpu")
    assert jax.tree.structure(ref) == jax.tree.structure(out)
    for j, t in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
        np.testing.assert_array_equal(t.numpy(), j)


def test_cuda_is_the_default_device():
    """Entry points run on CUDA unless the caller names the CPU; without
    a card they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _cfgs(2, 16, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfield.init_field_params(np.random.default_rng(0), tcfg)
