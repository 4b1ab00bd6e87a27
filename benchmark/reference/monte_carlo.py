"""Plain PyTorch reference of IBL-NeRF's test render under Monte-Carlo GGX
shading.

Independent of the program under test: it imports nothing of the port,
only `benchmark.reference.nerf`'s field, sampling and compositing, and
takes only raw inputs (parameters, rays, ground-truth normals). The passes
are `nerf.render_pixels`': 64 stratified samples through the density-only
coarse query, 128 more by inverse-CDF sampling of its weights, the fine
pass's full query at the gradient path's precision and the intrinsic maps
on its weights. In the shaded pass Monte-Carlo integration of the
microfacet BRDF replaces split-sum, written out from the IBL-NeRF paper
(arXiv:2210.08202), whose split-sum model approximates this integral, and
from the reference repository's Monte-Carlo baseline
(`src/utils/math_utils.py`: the square-to-hemisphere map and the tangent
frame; `src/nerf_models/microfacet.py`: the GGX BRDF):

- n x n directions about +z at the cells' centres of the unit square,
  ((i + 1/2) / n, (j + 1/2) / n), direction i * n + j, through the
  area-preserving concentric map (Shirley and Chiu): a disc point of
  radius r, then (x sqrt(2 - r^2), y sqrt(2 - r^2), 1 - r^2); computed in
  float64, stored in float32;
- each turned about the shading normal n in the frame (t, b, n): b is
  (-n_y, n_x, 0) where n_x > n_z, else (0, -n_z, n_y), normalised, and
  t = b x n;
- an incident march along each direction l from the surface point over the
  coarse pass's 64 stratified depths, the full field at the sweeps'
  precision (`Precision.sweep`) with l as its view direction, composited
  into the radiance head's colour;
- f0 = 0.04 (1 - m) + albedo m with metallic m = 1 - roughness, alpha =
  roughness^2, h = normalize(l + v); Schlick's F = f0 + (1 - f0)(1 - l.h)^5,
  GGX's D = alpha^2 / (pi ((h.n)^2 (alpha^2 - 1) + 1)^2 + 1e-5), Smith's G
  with k = alpha^2 / 2 for l and v, each n.x / (n.x (1 - k) + k + 1e-5); the
  glossy term F G D / (4 (l.n)(v.n) + 1e-5), the diffuse (1 - F) (1 - m)
  albedo / pi; every cosine clamped to [0, 1];
- specular and diffuse each (2 pi / M) sum over the M directions of the
  term times the incident radiance times l.n: the uniform hemisphere's
  weight.

Where this departs from the reference repository, or reads it:
- The centre cell of an odd n (r = 0) maps to (0, 1, 0), as the
  reference's map returns there: a direction in the tangent plane, whose
  l.n of 0 weighs nothing, marched all the same (with n = 3, 8 of the 9
  directions carry weight).
- The incident marches composite the radiance head only; the program
  composites the K coarse-radiance heads too and drops them, and no
  buffer exports them.
- Under the fast test path the coarse pass is density-only (the port's
  `coarse_shading=False`), and nothing is jittered.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import nerf
from benchmark.reference.nerf import (accumulate, field, normalize, posenc, sample_pdf,
                                      stratified, weights_of)
# what the traffic kind reads of a reference module besides render_pixels
from benchmark.reference.nerf import control, rays_full_image, stated  # noqa: F401

SUPPORTED = dict(nerf.SUPPORTED, shading_mode="monte_carlo")
NO_HEADS = ("infer_normal", "infer_depth", "infer_albedo_separate", "infer_roughness_separate",
            "infer_irradiance_separate")

# the bias of the BRDF's denominators (microfacet.py)
BIAS = 1e-5


def check_supported(args: dict) -> None:
    bad = {k: args[k] for k, v in SUPPORTED.items() if args[k] != v}
    bad.update({k: True for k in NO_HEADS if args.get(k)})
    if bad:
        raise NotImplementedError(f"the Monte-Carlo reference does not model {bad}")


def hemisphere_directions(n: int) -> torch.Tensor:
    """(n * n, 3) float32 unit directions about +z, by the area-preserving
    concentric map of the cells' centres."""
    out = []
    for i in range(n):
        for j in range(n):
            a, b = 2.0 * (i + 0.5) / n - 1.0, 2.0 * (j + 0.5) / n - 1.0
            if a == 0.0 and b == 0.0:
                out.append((0.0, 1.0, 0.0))
                continue
            if abs(a) > abs(b):
                r, phi = a, math.pi / 4 * (b / a)
            else:
                r, phi = b, math.pi / 2 - math.pi / 4 * (a / b)
            s = math.sqrt(2.0 - r * r)
            out.append((r * math.cos(phi) * s, r * math.sin(phi) * s, 1.0 - r * r))
    return torch.tensor(out, dtype=torch.float64).float()


def tangent_frame(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(tangent, binormal) of unit normals (..., 3)."""
    nx, ny, nz = normal.unbind(-1)
    zero = torch.zeros_like(nx)
    binormal = normalize(torch.where((nx > nz)[..., None], torch.stack([-ny, nx, zero], -1),
                                     torch.stack([zero, -nz, ny], -1)))
    return torch.linalg.cross(binormal, normal, dim=-1), binormal


def incident_directions(normal: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n * n, 3) unit world directions about each normal (B, 3)."""
    local = hemisphere_directions(n).to(normal.device)
    t, b = tangent_frame(normal)
    return normalize(local[:, 0, None] * t[:, None] + local[:, 1, None] * b[:, None]
                     + local[:, 2, None] * normal[:, None])


def incident_radiance(params, x_surface, dirs, z_const, args, prec) -> torch.Tensor:
    """(B, M, 3): the radiance head composited along each direction (B, M,
    3) from the surface point (B, 3) over the depths z_const (B, S)."""
    b, m, _ = dirs.shape
    z = z_const[:, None, :].expand(b, m, z_const.shape[-1])
    pts = x_surface[:, None, None, :] + dirs[:, :, None, :] * z[..., None]
    de = posenc(dirs, args["multires_views"])[:, :, None, :].expand(*pts.shape[:-1], -1)
    raw = field(params, posenc(pts, args["multires"]), de, prec.sweep)
    return accumulate(weights_of(raw[..., 0], z, dirs), torch.sigmoid(raw[..., 6:9]))


def ggx(l, v, n, albedo, rough):
    """Glossy and diffuse BRDF terms (B, M, 3) and l.n (B, M) of the
    directions l (B, M, 3) seen from v (B, 3) about n (B, 3), with albedo
    (B, 3) and roughness (B,)."""
    l, v, n = normalize(l), normalize(v), normalize(n)
    h = normalize(l + v[:, None])
    metallic = (1.0 - rough)[:, None]
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    l_h = torch.clamp(torch.sum(l * h, -1), 0.0, 1.0)
    fresnel = f0[:, None] + (1.0 - f0[:, None]) * ((1.0 - l_h) ** 5)[..., None]
    a2 = (rough ** 2)[:, None] ** 2
    l_n = torch.clamp(torch.sum(l * n[:, None], -1), 0.0, 1.0)
    v_n = torch.clamp(torch.sum(v * n, -1), 0.0, 1.0)[:, None]
    h_n = torch.clamp(torch.sum(h * n[:, None], -1), 0.0, 1.0)
    d = a2 / (math.pi * (h_n ** 2 * (a2 - 1.0) + 1.0) ** 2 + BIAS)
    k = a2 / 2.0
    g = (l_n / (l_n * (1.0 - k) + k + BIAS)) * (v_n / (v_n * (1.0 - k) + k + BIAS))
    glossy = fresnel * (g * d / (4.0 * l_n * v_n + BIAS))[..., None]
    diffuse = (1.0 - fresnel) * ((1.0 - metallic) * albedo / math.pi)[:, None]
    return glossy, diffuse, l_n


def _shaded_pass(params, rays_o, rays_d, z, z_const, args, prec, normal_gt):
    """The fine pass: intrinsic maps, the normal and Monte-Carlo shading."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    de = posenc(rays_d, args["multires_views"])[:, None, :].expand(*pts.shape[:-1], -1)
    raw = field(params, posenc(pts, args["multires"]), de, prec.grad)
    weights = weights_of(raw[..., 0], z, rays_d)
    depth, acc = torch.sum(weights * z, -1), torch.sum(weights, -1)
    albedo = accumulate(weights, torch.sigmoid(raw[..., 1:4]))
    rough = accumulate(weights, torch.sigmoid(raw[..., 4]))
    out = {"depth_map": depth, "acc_map": acc, "target_depth_map": depth,
           "disp_map": 1.0 / torch.clamp(depth / acc, min=1e-10),
           "radiance_map": accumulate(weights, torch.sigmoid(raw[..., 6:9])),
           "irradiance_map": accumulate(weights, torch.sigmoid(raw[..., 5]))[..., None],
           "albedo_map": albedo, "roughness_map": rough}
    for i in range(args["coarse_radiance_number"]):
        out[f"radiance_map_{i + 1}"] = accumulate(
            weights, torch.sigmoid(raw[..., 9 + 3 * i:12 + 3 * i]))

    if normal_gt is not None:
        normal = normalize(2.0 * normal_gt - 1.0)
    else:
        normal = nerf.eps_normals(
            lambda p: field(params, posenc(p, args["multires"]), None, prec.sweep)[..., 0],
            rays_o, rays_d, z, args["epsilon_for_numerical_normal"])
    x_surface = rays_o + rays_d * depth[:, None]
    dirs = incident_directions(normal, args["mc_samples_axis"])
    incident = incident_radiance(params, x_surface, dirs, z_const, args, prec)
    glossy, diffuse, l_n = ggx(dirs, -rays_d, normal, albedo, rough)
    weight = 2.0 * math.pi / dirs.shape[1]
    specular = weight * torch.sum(glossy * incident * l_n[..., None], 1)
    diffuse = weight * torch.sum(diffuse * incident * l_n[..., None], 1)
    out.update({"color_map": diffuse + specular, "specular_map": specular,
                "diffuse_map": diffuse, "target_normal_map": normal,
                "n_dot_v_map": torch.clamp(torch.sum(-rays_d * normal, -1), 0.0, 1.0)})
    return out


def render_rays(V, rays_o, rays_d, near, far, args, prec, normal_gt=None) -> dict:
    """The fast test render of the rays: the density-only coarse pass, the
    importance samples from its weights, the shaded fine pass."""
    near = torch.full_like(rays_o[:, :1], near)
    far = torch.full_like(rays_o[:, :1], far)
    z = stratified(near, far, args["N_samples"], None)
    coarse = nerf._depth_only(V["coarse"], rays_o, rays_d, z, args, prec)
    z_new = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), coarse["weights"][..., 1:-1],
                       args["N_importance"], None)
    z_all, _ = torch.sort(torch.cat([z, z_new], -1), dim=-1)
    return _shaded_pass(V.get("fine", V["coarse"]), rays_o, rays_d, z_all, z, args, prec,
                        normal_gt)


def render_pixels(V, lut, rays_o, rays_d, near, far, args, prec, normal_gt=None,
                  block: int = 1024) -> dict:
    """The exported buffers of the fast test render at the given rays, in
    blocks of rays (each block's incident marches query block x M x S
    points), without a graph. `lut` is unused: no split-sum table."""
    nerf.set_matmul_precision()
    check_supported(args)
    outs = []
    with torch.no_grad():
        for i in range(0, rays_o.shape[0], block):
            sl = slice(i, i + block)
            out = render_rays(V, rays_o[sl], rays_d[sl], near, far, args, prec,
                              None if normal_gt is None else normal_gt[sl])
            outs.append(nerf.exported(out, far, args["coarse_radiance_number"]))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
