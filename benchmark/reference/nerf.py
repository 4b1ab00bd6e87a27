"""Plain PyTorch reference of IBL-NeRF's training update and test render.

Independent of the program under test: it imports nothing of the port
and takes only raw inputs (parameters, scene arrays, draws, the BRDF
look-up table as stored). It follows the IBL-NeRF paper (arXiv:2210.08202)
and the reference implementation's defaults for the paths the benchmark
runs: hierarchical sampling (64 stratified + 128 importance samples), the
8x256 field with its skip at layer 4 and K prefiltered radiance heads,
intrinsic compositing on detached weights, ground-truth or
finite-difference normals, split-sum shading (BRDF LUT, roughness-aware
Fresnel, a reflected march along the coarse samples, the mip lookup), the
auxiliary heads and the depth-volume pass, the losses, and Adam.

Precision is explicit. `Precision.grad` is what the gradient path's field
products use: "bf16" rounds every operand (activations, deltas, weights)
to bfloat16 and sums in float32, as the configuration's `bf16_grad`
states; "fp8" rounds them to scaled float8 (e4m3 forward, e5m2 backward).
`Precision.sweep` is the no-grad sweeps', `Precision.aux` the auxiliary
heads': "f32" (TF32 off), "tf32" (operands rounded to TF32's 10-bit
mantissa), "bf16". `stated` gives the precision the configuration's
compute dtype states; `control`, one step below it, is the control of the
benchmark's comparison.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    grad: str = "bf16"     # the gradient path's field products
    sweep: str = "f32"     # the no-grad sweeps' field products
    aux: str = "f32"       # the auxiliary heads' products


# (gradient path, sweeps) of each compute dtype modelled, and the step
# below each
_DTYPES = {"float32": ("f32", "f32"), "bf16_grad": ("bf16", "f32")}
_BELOW = {"f32": "tf32", "bf16": "fp8"}


def stated(args: dict) -> Precision:
    """The precision the configuration's compute dtype states."""
    return Precision(*_DTYPES[args["compute_dtype"]], "f32")


def control(args: dict) -> Precision:
    """One step below the stated precision everywhere: TF32 for float32
    with TF32 off, scaled float8 for bfloat16."""
    p = stated(args)
    return Precision(_BELOW[p.grad], _BELOW[p.sweep], _BELOW[p.aux])


_FP8 = {"fp8": (torch.float8_e4m3fn, 448.0), "fp8_bwd": (torch.float8_e5m2, 57344.0)}


def quantize(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    dt, top = _FP8[mode]
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dt).float() / scale


class _Round(torch.autograd.Function):
    """Rounds an activation forward and its gradient backward."""

    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return quantize(x, mode)

    @staticmethod
    def backward(ctx, g):
        return quantize(g, "fp8_bwd" if ctx.mode == "fp8" else ctx.mode), None


def _act(x, mode):
    return x if mode == "f32" else _Round.apply(x, mode)


def _wt(w, mode):
    """The weight as the product reads it; its gradient stays float32."""
    return w if mode == "f32" else w + (quantize(w, mode) - w).detach()


def mm(a, w, mode):
    return _act(a, mode) @ _wt(w, mode)


def dense(p, x, mode):
    return mm(x, p["w"], mode) + _wt(p["b"], mode)


def set_matmul_precision() -> None:
    """float32 products in full precision on the card: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# ---------------------------------------------------------------------------
# The field and the auxiliary heads
# ---------------------------------------------------------------------------

def posenc(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def _trunk(layers, pe, mode):
    h = pe
    for i, layer in enumerate(layers):
        h = torch.relu(dense(layer, h, mode))
        if i == 4:
            h = torch.cat([pe, h], dim=-1)
    return h


def density(p: dict, pe: torch.Tensor, mode: str, tensors: bool = False) -> torch.Tensor:
    """Raw sigma (..., 1). With `tensors`, in the arithmetic of tensors held
    in the low precision (bf16 or fp8), as an eager query computes: each
    product and each sum rounded; sigma's own product and sum in float32.
    Without a graph."""
    if not tensors or mode not in ("bf16", "fp8"):
        return field(p, pe, None, mode)
    x = quantize(pe, mode)
    h = x
    for i, layer in enumerate(p["trunk"]):
        y = quantize(h @ quantize(layer["w"], mode), mode)
        h = torch.relu(quantize(y + quantize(layer["b"], mode), mode))
        if i == 4:
            h = torch.cat([x, h], dim=-1)
    return h @ quantize(p["sigma"]["w"], mode) + quantize(p["sigma"]["b"], mode)


def field(p: dict, pe: torch.Tensor, de: torch.Tensor | None, mode: str) -> torch.Tensor:
    """Raw [sigma, albedo3, roughness, irradiance, radiance3, coarse3 x K]
    of a fused query (operands rounded, sums in float32, each activation
    rounded once), or sigma (..., 1) alone when `de` is None."""
    h = _trunk(p["trunk"], pe, mode)
    sigma = dense(p["sigma"], h, mode)
    if de is None:
        return sigma
    w = p["feature"]["w"].shape[0]
    half = w // 2
    pos = torch.relu(mm(h, torch.cat([p["albedo_feat"]["w"], p["irradiance_feat"]["w"]], 1),
                        mode)
                     + _wt(torch.cat([p["albedo_feat"]["b"], p["irradiance_feat"]["b"]]), mode))
    feat = dense(p["feature"], h, mode)
    vw = p["views"][0]["w"]
    hv = torch.relu(mm(feat, vw[:w], mode) + mm(de, vw[w:], mode)
                    + _wt(p["views"][0]["b"], mode))
    cols = [sigma, dense(p["albedo"], pos[..., :half], mode), dense(p["roughness"], h, mode),
            dense(p["irradiance"], pos[..., half:], mode), dense(p["radiance"], hv, mode)]
    for cf, c in zip(p["coarse_feat"], p["coarse"]):
        cols.append(dense(c, torch.relu(dense(cf, hv, mode)), mode))
    return torch.cat(cols, dim=-1)


def position_mlp(p, pe, mode):
    return dense(p["out"], _trunk(p["trunk"], pe, mode), mode)


def position_direction_mlp(p, pe, de, mode):
    h2 = torch.cat([dense(p["feature"], _trunk(p["trunk"], pe, mode), mode), de], dim=-1)
    for layer in p["views"]:
        h2 = torch.relu(dense(layer, h2, mode))
    return dense(p["out"], h2, mode)


# ---------------------------------------------------------------------------
# Compositing, sampling, shading
# ---------------------------------------------------------------------------

def dists(z, rays_d):
    d = z[..., 1:] - z[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], 1e10)], dim=-1)
    return d * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)


def weights_of(sigma_raw, z, rays_d):
    alpha = 1.0 - torch.exp(-torch.relu(sigma_raw) * dists(z, rays_d))
    t = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    return alpha * torch.cat([torch.ones_like(t[..., :1]), t[..., :-1]], dim=-1)


def accumulate(weights, values):
    if values.ndim == weights.ndim:
        return torch.sum(weights * values, dim=-1)
    return torch.sum(weights[..., None] * values, dim=-2)


def stratified(near, far, n, u):
    t = torch.linspace(0.0, 1.0, n, dtype=near.dtype, device=near.device)
    z = near * (1.0 - t) + far * t
    if u is None:
        return z.expand(near.shape[0], n)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def sample_pdf(bins, weights, n, u):
    """Inverse-CDF sampling; `u` None samples deterministically."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n)
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)


def lut_fetch(lut, uv):
    """Bilinear, align_corners=True, clamped to the border."""
    h, w, c = lut.shape
    x = torch.clamp((uv[..., 0] + 1.0) * 0.5 * (w - 1), 0, w - 1)
    y = torch.clamp((uv[..., 1] + 1.0) * 0.5 * (h - 1), 0, h - 1)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = lut.reshape(h * w, c)

    def at(yi, xi):
        return flat[(yi.long() * w + xi.long())]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bottom = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bottom * wy


def mip_interp(levels, level):
    n = levels.shape[-2]
    lv = level * (n - 1)
    i1 = torch.clamp(lv.long(), 0, n - 1)
    i2 = torch.clamp(i1 + 1, 0, n - 1)
    rem = (lv - i1.to(lv.dtype))[..., None]
    rows = torch.arange(levels.shape[0], device=levels.device)
    return (1.0 - rem) * levels[rows, i1] + rem * levels[rows, i2]


def normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def eps_normals(density, rays_o, rays_d, z, eps):
    """Normals from finite differences of the depth under four position
    offsets along the pixel's right and up vectors."""
    up_world = torch.zeros_like(rays_d)
    up_world[..., 1] = 1.0
    right = torch.linalg.cross(rays_d, up_world, dim=-1)
    up = torch.linalg.cross(right, rays_d, dim=-1)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z[..., None]
    depth = [torch.sum(weights_of(density(pts + eps * off[:, None, :]), z, rays_d) * z, -1)
             for off in (right, -right, up, -up)]
    dx = 2 * eps * right + (depth[0] - depth[1])[..., None] * rays_d
    dy = 2 * eps * up + (depth[2] - depth[3])[..., None] * rays_d
    return normalize(torch.linalg.cross(dx, dy, dim=-1))


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

SUPPORTED = {"shading_mode": "split_sum", "lut_coefficient": "F", "gamma_correct": False,
             "use_radiance_linear": False, "raw_noise_std": 0.0, "lindisp": False,
             "correct_depth_for_prefiltered_radiance_infer": True,
             "use_gradient_for_incident_radiance": False, "infer_normal_at_surface": False,
             "depth_map_from_ground_truth": False, "color_independent_to_direction": False}


def check_supported(args: dict) -> None:
    bad = {k: args[k] for k, v in SUPPORTED.items() if args[k] != v}
    if bad:
        raise NotImplementedError(f"the reference does not model {bad}")


def _pass(V, params, lut, rays_o, rays_d, z, z_const, near, far, args, prec, normal_gt):
    """One shaded pass over samples z: the intrinsic maps, the normal and
    split-sum shading."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    pe = posenc(pts, args["multires"])
    de = posenc(rays_d, args["multires_views"])[:, None, :].expand(*pts.shape[:-1], -1)
    raw = field(params, pe, de, prec.grad)
    weights = weights_of(raw[..., 0], z, rays_d)
    w_det = weights.detach()
    depth = torch.sum(weights * z, -1)
    acc = torch.sum(weights, -1)
    out = {"weights": weights, "depth_map": depth, "acc_map": acc,
           "disp_map": 1.0 / torch.clamp(depth / acc, min=1e-10), "target_depth_map": depth}
    x_surface = (rays_o + rays_d * depth[:, None]).detach()

    heads = {}
    for name, flag, head in (("normal", "infer_normal", "normal_mlp"),
                             ("albedo", "infer_albedo_separate", "albedo_mlp"),
                             ("roughness", "infer_roughness_separate", "roughness_mlp"),
                             ("irradiance", "infer_irradiance_separate", "irradiance_mlp")):
        if args.get(flag):
            v = torch.sigmoid(position_mlp(V[head], pe, prec.aux))
            if name == "normal":
                heads[name] = accumulate(w_det, 2.0 * v - 1.0)
            else:
                heads[name] = accumulate(w_det, v if name == "albedo" else v[..., 0])
    albedo = heads.get("albedo", accumulate(w_det, torch.sigmoid(raw[..., 1:4])))
    rough = heads.get("roughness", accumulate(w_det, torch.sigmoid(raw[..., 4])))
    irr = heads.get("irradiance", accumulate(w_det, torch.sigmoid(raw[..., 5])))[..., None]
    out["radiance_map"] = accumulate(weights, torch.sigmoid(raw[..., 6:9]))
    k = args["coarse_radiance_number"]
    for i in range(k):
        out[f"radiance_map_{i + 1}"] = accumulate(w_det, torch.sigmoid(raw[..., 9 + 3 * i:12 + 3 * i]))
    if "normal" in heads:
        out["inferred_normal_map"] = heads["normal"]

    if normal_gt is not None:
        normal = normalize(2.0 * normal_gt - 1.0)
    else:
        with torch.no_grad():
            normal = eps_normals(lambda p: field(params, posenc(p, args["multires"]), None,
                                                 prec.sweep)[..., 0],
                                 rays_o, rays_d, z, args["epsilon_for_numerical_normal"])
    n_dot_v = torch.clamp(torch.sum(-rays_d * normal, -1), 0.0, 1.0)
    env = lut_fetch(lut, torch.stack([2.0 * n_dot_v - 1.0, 2.0 * rough - 1.0], -1))
    metallic = (1.0 - rough)[..., None]
    f0 = 0.04 * (1.0 - metallic) + albedo * metallic
    fresnel = f0 + (torch.maximum(1.0 - rough[..., None], f0) - f0) * torch.pow(
        torch.clamp(1.0 - n_dot_v[..., None], 0.0, 1.0), 5.0)
    spec_coeff = fresnel * env[..., 0:1] + env[..., 1:2]

    refl = rays_d - 2.0 * torch.sum(normal * rays_d, -1, keepdim=True) * normal
    with torch.no_grad():
        r_pts = x_surface[:, None, :] + refl[:, None, :] * z_const[..., None]
        r_de = posenc(refl, args["multires_views"])[:, None, :].expand(*r_pts.shape[:-1], -1)
        r_raw = field(params, posenc(r_pts, args["multires"]), r_de, prec.sweep)
        r_w = weights_of(r_raw[..., 0], z_const, refl)
        stack = [accumulate(r_w, torch.sigmoid(r_raw[..., 6 + 3 * i:9 + 3 * i]))
                 for i in range(k + 1)]
    mip = torch.clamp(rough * depth.detach() / ((far + near) * 0.5)[..., 0], 0.0, 1.0)
    prefiltered = mip_interp(torch.stack(stack, 1), mip)
    diffuse = (1.0 - fresnel) * (1.0 - metallic) * albedo * irr
    specular = spec_coeff * prefiltered
    out.update({"color_map": diffuse + specular, "irradiance_map": irr,
                "reflected_radiance_map": stack[0], "prefiltered_reflected_map": prefiltered,
                "albedo_map": albedo, "roughness_map": rough, "specular_map": specular,
                "diffuse_map": diffuse, "n_dot_v_map": n_dot_v, "target_normal_map": normal})
    for i in range(k):
        out[f"reflected_coarse_radiance_map_{i + 1}"] = stack[i + 1]
    return out


def _depth_only(params, rays_o, rays_d, z, args, prec):
    """Weights and depth from the gradient path's density query, which runs
    eagerly on tensors of its precision."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    with torch.no_grad():
        sigma = density(params, posenc(pts, args["multires"]), prec.grad, tensors=True)[..., 0]
    weights = weights_of(sigma, z, rays_d)
    return {"weights": weights, "depth_map": torch.sum(weights * z, -1)}


def render_rays(V, lut, rays_o, rays_d, near, far, args, prec, draws=None, normal_gt=None,
                depth_only=False, shade_coarse=True):
    """Coarse pass, importance samples from its weights, fine pass; the
    coarse pass's maps suffixed "0". `draws` None renders without jitter
    (the test path); `shade_coarse` False renders the coarse pass for its
    weights alone (the fast test path)."""
    near = torch.full_like(rays_o[:, :1], near)
    far = torch.full_like(rays_o[:, :1], far)
    draws = draws or {}
    z = stratified(near, far, args["N_samples"], draws.get("strat"))
    if depth_only or not shade_coarse:
        coarse = _depth_only(V["coarse"], rays_o, rays_d, z, args, prec)
    else:
        coarse = _pass(V, V["coarse"], lut, rays_o, rays_d, z, z, near, far, args, prec,
                       normal_gt)
    with torch.no_grad():
        z_new = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), coarse["weights"][..., 1:-1],
                           args["N_importance"], draws.get("pdf"))
    z_all, _ = torch.sort(torch.cat([z, z_new], -1), dim=-1)
    fine_params = V.get("fine", V["coarse"])
    if depth_only:
        out = _depth_only(fine_params, rays_o, rays_d, z_all, args, prec)
    else:
        out = _pass(V, fine_params, lut, rays_o, rays_d, z_all, z, near, far, args, prec,
                    normal_gt)
    out.update({key + "0": v for key, v in coarse.items()})
    if args.get("infer_depth"):
        viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
        d = position_direction_mlp(V["depth_mlp"], posenc(rays_o, args["multires"]),
                                   posenc(viewdirs, args["multires_views"]), prec.aux)
        out["inferred_depth_map"] = torch.relu(d[..., 0])
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def rays_for_pixels(arrays, img, u, v):
    c2w = arrays["poses"][img][:, :3, :4]
    kk = arrays["K"]
    dirs = torch.stack([(u.float() - kk[0, 2]) / kk[0, 0], -(v.float() - kk[1, 2]) / kk[1, 1],
                        -torch.ones_like(u, dtype=torch.float32)], -1)
    rays_d = torch.sum(dirs[:, None, :] * c2w[:, :3, :3], -1)
    return c2w[:, :3, 3].expand_as(rays_d), rays_d


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def loss(V, lut, arrays, scene, draws, args, prec, rows: slice):
    """The `rows` block's share of the total loss of one update at the phase
    the benchmark runs (approximated radiance on, priors off, the
    inferred-normal and depth losses on where their heads are): each mean
    over the batch taken over the block and weighted by its share of the
    batch; the depth-volume pass's term, over the batch's first rays, in
    the block that holds them. The shares of all blocks sum to the loss."""
    px = draws["pixels"]
    n_rand = px["u"].shape[0]
    img, u, v = px["img"][rows], px["u"][rows], px["v"][rows]
    share = (img.shape[0]) / n_rand
    rgb = arrays["images"][img, v, u]
    normal_gt = arrays["normal"][img, v, u]
    rays_o, rays_d = rays_for_pixels(arrays, img, u, v)
    near, far = scene["near"], scene["far"]
    out = render_rays(V, lut, rays_o, rays_d, near, far, args, prec,
                      {k: x[rows] for k, x in draws["render"].items()}, normal_gt)
    total = 0.0
    for p in ("", "0"):
        total = total + _mse(out["radiance_map" + p], rgb)
        for i in range(args["coarse_radiance_number"]):
            total = total + _mse(out[f"radiance_map_{i + 1}" + p],
                                 arrays["prefiltered_images"][i][img, v, u])
        total = total + args["beta_render"] * _mse(out["color_map" + p], rgb)
    if args.get("infer_normal"):
        total = total + args["beta_inferred_normal"] * sum(
            _mse(out["inferred_normal_map" + p], out["target_normal_map" + p])
            for p in ("", "0"))
    if args.get("infer_depth"):
        total = total + args["beta_inferred_depth"] * _mse(out["inferred_depth_map"],
                                                           out["depth_map"].detach())
    total = total * share
    n_vol = min(args["N_depth_random_volume"], n_rand) if args.get("infer_depth") else 0
    if rows.start == 0 and n_vol:
        if rays_o.shape[0] < n_vol:
            raise ValueError("the first block must hold the depth-volume pass's rays")
        normal = normalize(2.0 * normal_gt[:n_vol] - 1.0)
        x_s = (rays_o[:n_vol] + rays_d[:n_vol] * out["depth_map"][:n_vol, None]).detach()
        rand = 2.0 * draws["vol"]["dirs"] - 1.0
        rand = normalize(torch.sign(torch.sum(rand * normal, -1))[..., None] * rand)
        vol = render_rays(V, lut, x_s, rand, near, far, args, prec, draws["vol"]["render"],
                          depth_only=True)
        total = total + args["beta_inferred_depth"] * _mse(vol["inferred_depth_map"],
                                                           vol["depth_map"].detach())
    return total


def leaves(tree, prefix=""):
    """(path, tensor) of every leaf, dicts in insertion order, lists in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def adam_step(params, grads, moments, lr_of, counts, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with bias correction from the group's count, in float32."""
    with torch.no_grad():
        for group, names in moments["groups"].items():
            c = counts[group] + 1
            lr = lr_of(group, counts[group])
            bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
            for name in names:
                g, p = grads[name], params[name]
                m, s = moments["mu"][name], moments["nu"][name]
                m.mul_(b1).add_((1.0 - b1) * g)
                s.mul_(b2).add_((1.0 - b2) * g * g)
                p.sub_(lr * (m / bc1) / (torch.sqrt(s / bc2) + eps))
            counts[group] = c


def train_steps(variables, lut, arrays, scene, draws_list, args, prec, counts,
                lr_of, block: int = 1024) -> dict:
    """Follow the updates of `draws_list` from `variables` (left as they
    are), each update's gradients summed over blocks of `block` rays.
    Returns each update's loss, the norm of each leaf's first gradient and
    of its change over all the updates."""
    set_matmul_precision()
    check_supported(args)
    V = {g: _clone(t) for g, t in variables.items()}
    named = dict(leaves(V))
    start = {k: v.detach().clone() for k, v in named.items()}
    groups = {g: [k for k, _ in leaves(V[g], g)] for g in V}
    moments = {"groups": groups, "mu": {k: torch.zeros_like(v) for k, v in named.items()},
               "nu": {k: torch.zeros_like(v) for k, v in named.items()}}
    counts = dict(counts)
    losses, first = [], None
    for draws in draws_list:
        n_rand = draws["pixels"]["u"].shape[0]
        grads = {k: torch.zeros_like(v) for k, v in named.items()}
        total = 0.0
        for b0 in range(0, n_rand, block):
            part = loss(V, lut, arrays, scene, draws, args, prec,
                        slice(b0, min(b0 + block, n_rand)))
            got = torch.autograd.grad(part, list(named.values()), allow_unused=True)
            for (k, _), g in zip(named.items(), got):
                if g is not None:
                    grads[k] += g
            total += part.item()
        losses.append(total)
        if first is None:
            first = {k: g.norm().item() for k, g in grads.items()}
        adam_step(named, grads, moments, lr_of, counts)
    change = {k: (named[k].detach() - start[k]).norm().item() for k in named}
    return {"losses": losses, "first_grad": first, "change": change}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


def lr_schedule(lrate: float, decay_steps: float, lr_overrides: dict):
    """lr of a group's update at count c: lrate 0.1^(max(c - 1, 0) / decay)."""
    def lr_of(group, count):
        base = lr_overrides.get(group, lrate)
        return base * 0.1 ** (max(count - 1, 0) / decay_steps)
    return lr_of


# ---------------------------------------------------------------------------
# The test render's exported buffers
# ---------------------------------------------------------------------------

EXPORTS = (("color_map", "rgb"), ("radiance_map", "radiance"),
           ("irradiance_map", "irradiance"), ("albedo_map", "albedo"),
           ("reflected_radiance_map", "reflected_radiance"),
           ("prefiltered_reflected_map", "prefiltered_reflected"),
           ("roughness_map", "roughness"), ("specular_map", "specular"),
           ("diffuse_map", "diffuse"), ("n_dot_v_map", "n_dot_v"),
           ("inferred_normal_map", "inferred_normal_map"),
           ("target_normal_map", "target_normal_map"), ("inferred_depth_map", "inferred_disp"),
           ("disp_map", "disp"), ("depth_map", "depth"), ("target_depth_map", "target_depth"))


def exported(out: dict, far: float, k: int) -> dict:
    """The buffers a test render exports, in their display transforms:
    normals as (n + 1) / 2, depths as disparity against far / 10."""
    pairs = list(EXPORTS) + [(f"radiance_map_{i + 1}", f"radiance_{i + 1}") for i in range(k)]
    pairs += [(f"reflected_coarse_radiance_map_{i + 1}", f"reflected_coarse_radiance_{i + 1}")
              for i in range(k)]
    res = {}
    for key, name in pairs:
        if key not in out:
            continue
        x = out[key]
        if "normal" in name:
            x = (x + 1.0) * 0.5
        elif "depth" in key:
            x = 1.0 / torch.clamp(x / (far * 0.1), min=1e-10)
        res[name] = x
    res["acc"] = out["acc_map"]
    return res


def render_pixels(V, lut, rays_o, rays_d, near, far, args, prec, normal_gt=None,
                  block: int = 4096) -> dict:
    """The exported buffers of the fast test render at the given rays, in
    blocks of rays, without a graph."""
    set_matmul_precision()
    check_supported(args)
    outs = []
    with torch.no_grad():
        for i in range(0, rays_o.shape[0], block):
            sl = slice(i, i + block)
            out = render_rays(V, lut, rays_o[sl], rays_d[sl], near, far, args, prec,
                              normal_gt=None if normal_gt is None else normal_gt[sl],
                              shade_coarse=False)
            outs.append(exported(out, far, args["coarse_radiance_number"]))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def rays_full_image(h, w, focal, c2w):
    """(h * w, 3) origins and directions of a pinhole camera looking down -z."""
    j, i = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=c2w.device),
                          torch.arange(w, dtype=torch.float32, device=c2w.device),
                          indexing="ij")
    dirs = torch.stack([(i - 0.5 * w) / focal, -(j - 0.5 * h) / focal, -torch.ones_like(i)], -1)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1).reshape(-1, 3)
    return c2w[:3, 3].expand_as(rays_d), rays_d


