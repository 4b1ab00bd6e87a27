"""Plain PyTorch reference of IBL-NeRF's training update with ε-normals.

IBL-NeRF's own configurations train with `calculating_normal_type =
normal_map_from_depth_gradient_epsilon` (its reference code's
configs/common.txt and src/utils/normal_from_depth.py): each shaded
pass's normal comes from finite differences of the depth under four
offsets of ε along the pixel's right and up vectors, a no-grad density
sweep over every sample of the pass, at the sweeps' precision. This
module is `nerf.py`'s training loss and update with that normal in place
of the ground-truth one; everything else is `nerf.py`'s, by import. The
fine pass can be held on given importance samples (the program's), so
that the rounding of the gradient path's coarse weights, which moves the
samples and which the finite difference reads 1/(2ε) times larger, does
not reach the fine pass's normals; the reference's own samples are kept
for comparison.
Independent of the program under test: nothing of the port or of JAX.

It models the split-sum phase without auxiliary heads (the `eps_normals`
configuration); the depth-volume pass and the inferred-normal and depth
losses are left to `nerf.py`.
"""

from __future__ import annotations

import torch

from benchmark.reference import nerf
from benchmark.reference.nerf import control, leaves, lr_schedule, stated  # noqa: F401

UNMODELLED = ("infer_normal", "infer_depth", "infer_albedo_separate",
              "infer_roughness_separate", "infer_irradiance_separate",
              "infer_visibility", "use_environment_map")
EPS_NORMALS = "normal_map_from_depth_gradient_epsilon"


def check_supported(args: dict) -> None:
    nerf.check_supported(args)
    bad = {k: args[k] for k in UNMODELLED if args.get(k)}
    if args["calculating_normal_type"] != EPS_NORMALS or bad:
        raise NotImplementedError(
            f"the reference trains with {EPS_NORMALS} and no auxiliary heads, not "
            f"{args['calculating_normal_type']} with {bad}")


def render_rays(V, lut, rays_o, rays_d, near, far, args, prec, draws, z_fine=None):
    """`nerf.render_rays`' coarse pass, importance samples and fine pass,
    both passes shaded with their ε-normal, and the fine pass marched on
    `z_fine`, where given, in place of this reference's own importance
    samples, which the output keeps as "z_importance"."""
    near = torch.full_like(rays_o[:, :1], near)
    far = torch.full_like(rays_o[:, :1], far)
    z = nerf.stratified(near, far, args["N_samples"], draws["strat"])
    coarse = nerf._pass(V, V["coarse"], lut, rays_o, rays_d, z, z, near, far, args, prec, None)
    with torch.no_grad():
        z_own = nerf.sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), coarse["weights"][..., 1:-1],
                                args["N_importance"], draws["pdf"])
    z_all, _ = torch.sort(torch.cat([z, z_own if z_fine is None else z_fine], -1), dim=-1)
    out = nerf._pass(V, V.get("fine", V["coarse"]), lut, rays_o, rays_d, z_all, z, near, far,
                     args, prec, None)
    out.update({key + "0": v for key, v in coarse.items()})
    out["z_importance"] = z_own
    return out


def loss(V, lut, arrays, scene, draws, args, prec, rows: slice, z_fine=None):
    """The `rows` block's share of one update's total loss, `nerf.loss`'s
    terms (radiance, the K prefiltered radiances and the shaded colour of
    both passes), and the block's render."""
    px = draws["pixels"]
    img, u, v = px["img"][rows], px["u"][rows], px["v"][rows]
    rgb = arrays["images"][img, v, u]
    rays_o, rays_d = nerf.rays_for_pixels(arrays, img, u, v)
    out = render_rays(V, lut, rays_o, rays_d, scene["near"], scene["far"], args, prec,
                      {k: x[rows] for k, x in draws["render"].items()},
                      None if z_fine is None else z_fine[rows])
    total = 0.0
    for p in ("", "0"):
        total = total + nerf._mse(out["radiance_map" + p], rgb)
        for i in range(args["coarse_radiance_number"]):
            total = total + nerf._mse(out[f"radiance_map_{i + 1}" + p],
                                      arrays["prefiltered_images"][i][img, v, u])
        total = total + args["beta_render"] * nerf._mse(out["color_map" + p], rgb)
    return total * img.shape[0] / px["u"].shape[0], out


def train_steps(variables, lut, arrays, scene, draws_list, args, prec, counts,
                lr_of, z_fine=None, block: int = 1024) -> dict:
    """`nerf.train_steps` on this module's loss: follow the updates of
    `draws_list` from `variables` (left as they are), each update's
    gradients summed over blocks of `block` rays, its fine pass on
    `z_fine[i]` where given; each update's loss, the norm of each leaf's
    first gradient and of its change over the updates, and the first
    update's shading normals (coarse, fine) and own importance samples."""
    nerf.set_matmul_precision()
    check_supported(args)
    V = {g: nerf._clone(t) for g, t in variables.items()}
    named = dict(leaves(V))
    start = {k: p.detach().clone() for k, p in named.items()}
    moments = {"groups": {g: [k for k, _ in leaves(V[g], g)] for g in V},
               "mu": {k: torch.zeros_like(p) for k, p in named.items()},
               "nu": {k: torch.zeros_like(p) for k, p in named.items()}}
    counts = dict(counts)
    losses, first, normals, samples = [], None, [[], []], []
    for i, draws in enumerate(draws_list):
        n_rand = draws["pixels"]["u"].shape[0]
        grads = {k: torch.zeros_like(p) for k, p in named.items()}
        total = 0.0
        for b0 in range(0, n_rand, block):
            part, out = loss(V, lut, arrays, scene, draws, args, prec,
                             slice(b0, min(b0 + block, n_rand)),
                             None if z_fine is None else z_fine[i])
            got = torch.autograd.grad(part, list(named.values()), allow_unused=True)
            for k, g in zip(named, got):
                if g is not None:
                    grads[k] += g
            total += part.item()
            if i == 0:
                normals[0].append(out["target_normal_map0"])
                normals[1].append(out["target_normal_map"])
                samples.append(out["z_importance"])
        losses.append(total)
        if first is None:
            first = {k: g.norm().item() for k, g in grads.items()}
        nerf.adam_step(named, grads, moments, lr_of, counts)
    change = {k: (named[k].detach() - start[k]).norm().item() for k in named}
    return {"losses": losses, "first_grad": first, "change": change,
            "normals": [torch.cat(n) for n in normals], "samples": torch.cat(samples)}
