"""Everything a run feeds the program, made on the device from `--seed`.

The weights, the scene and each update's random draws come from
`torch.Generator`s on the run's device, one stream each, in a few large
calls. The program and the plain reference receive the same tensors.
Weights are torch.nn.Linear's init, weights and biases
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), but for the density head's bias, by
the cell's `weights` scheme. At this init each ReLU layer shrinks the
signal about sixfold, so the raw density is its bias to within about 0.01
(more at points far from the origin); with the default bias half of all
draws are dead over the whole scene (the training loop re-draws them) and
the rest sit at the ReLU's kink. "default": the bias from
U(1/(2 sqrt(fan_in)), 1/sqrt(fan_in)), a live field, the start of
training. "dense": the bias from U(0.5, 1): a field whose density is
positive everywhere with a wide margin and whose transmittance has all
but gone by the far plane, as at a trained scene's surfaces. A frame
needs it: NeRF's last sample spans 1e10, so where the transmittance is
left at the far plane, the last density's sign (which rounding decides
at the kink) moves a ray's whole colour, most of all on the reflected
march's far points. The tree mirrors the port's parameter layout, (in,
out) matrices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STREAMS = {"weights": 1, "scene": 2, "draws": 3, "sample": 4}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator for one of the run's streams, mixed from the seed (any
    size) and the stream's number."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64,
                                    STREAMS[stream]]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def embedding_channels(args: dict) -> tuple[int, int]:
    return 3 + 6 * args["multires"], 3 + 6 * args["multires_views"]


# ---------------------------------------------------------------------------
# Weights: (path, fan_in, fan_out) of every linear layer, in the port's order
# ---------------------------------------------------------------------------

def _trunk(depth: int, width: int, in_ch: int) -> list[int]:
    return [in_ch if i == 0 else (width + in_ch if i == 5 else width) for i in range(depth)]


def field_layers(args: dict) -> list[tuple]:
    d, w, k = args["netdepth"], args["netwidth"], args["coarse_radiance_number"]
    in_ch, in_v = embedding_channels(args)
    half = w // 2
    layers = [(("trunk", i), f, w) for i, f in enumerate(_trunk(d, w, in_ch))]
    layers += [(("sigma",), w, 1), (("albedo_feat",), w, half), (("albedo",), half, 3),
               (("roughness",), w, 1), (("irradiance_feat",), w, half),
               (("irradiance",), half, 1), (("feature",), w, w),
               (("views", 0), in_v + w, w), (("radiance",), w, 3)]
    layers += [(("coarse_feat", i), w, half) for i in range(k)]
    layers += [(("coarse", i), half, 3) for i in range(k)]
    return layers


def position_mlp_layers(args: dict, out_ch: int) -> list[tuple]:
    d, w = args["netdepth"], args["netwidth"]
    in_ch, _ = embedding_channels(args)
    return ([(("trunk", i), f, w) for i, f in enumerate(_trunk(d, w, in_ch))]
            + [(("out",), w, out_ch)])


def position_direction_mlp_layers(args: dict, out_ch: int) -> list[tuple]:
    d, w = args["netdepth"], args["netwidth"]
    in_ch, in_v = embedding_channels(args)
    half = w // 2
    return ([(("trunk", i), f, w) for i, f in enumerate(_trunk(d, w, in_ch))]
            + [(("feature",), w, w), (("views", 0), in_v + w, half)]
            + [(("views", i), half, half) for i in range(1, d // 2)]
            + [(("out",), half, out_ch)])


# The variable groups each flag adds, in the order the training loop
# builds them: (group, flag or None, layers, out_ch).
AUX_GROUPS = (("depth_mlp", "infer_depth", position_direction_mlp_layers, 1),
              ("visibility_mlp", "infer_visibility", position_direction_mlp_layers, 1),
              ("normal_mlp", "infer_normal", position_mlp_layers, 3),
              ("albedo_mlp", "infer_albedo_separate", position_mlp_layers, 3),
              ("roughness_mlp", "infer_roughness_separate", position_mlp_layers, 1),
              ("irradiance_mlp", "infer_irradiance_separate", position_mlp_layers, 1))


def variable_groups(args: dict) -> dict[str, list[tuple]]:
    groups = {"coarse": field_layers(args)}
    if args["N_importance"] > 0:
        groups["fine"] = field_layers(args)
    for name, flag, layers, out_ch in AUX_GROUPS:
        if args.get(flag):
            groups[name] = layers(args, out_ch)
    return groups


def _insert(tree: dict, path: tuple, leaf: dict) -> None:
    if len(path) == 1:
        tree[path[0]] = leaf
        return
    tree.setdefault(path[0], []).append(leaf)


def make_variables(args: dict, seed: int, device, scheme: str) -> dict:
    """Every trainable group the configuration has, as the port's tree of
    {"w": (in, out), "b": (out,)} f32 leaves, the density bias by `scheme`
    ("default" or "dense"); one uniform draw for all of them, scaled per
    layer. The environment map (2n, n, 3) is U[0, 0.1)."""
    sigma_bias = {"default": lambda u, bound: (u + 1.0) * 0.5 * bound,
                  "dense": lambda u, bound: 0.5 + 0.5 * u}[scheme]
    groups = variable_groups(args)
    sizes = [f * o + o for layers in groups.values() for _, f, o in layers]
    env = 2 * args["N_envmap_size"] ** 2 * 3 if args.get("use_environment_map") else 0
    gen = generator(seed, "weights", device)
    u = torch.rand(sum(sizes) + env, generator=gen, device=device)
    variables, at = {}, 0
    for name, layers in groups.items():
        tree = {}
        for path, fan_in, fan_out in layers:
            bound = 1.0 / math.sqrt(fan_in)
            n = fan_in * fan_out
            w = (u[at:at + n].view(fan_in, fan_out) * 2 - 1) * bound
            b = u[at + n:at + n + fan_out]
            b = sigma_bias(b, bound) if path == ("sigma",) else (b * 2 - 1) * bound
            at += n + fan_out
            _insert(tree, path, {"w": w, "b": b})
        variables[name] = tree
    if env:
        n = args["N_envmap_size"]
        variables["env_map"] = {"emission": u[at:at + env].view(2 * n, n, 3) * 0.1}
    return variables


# ---------------------------------------------------------------------------
# The scene: Kitchen's 480x640 frame, random images, gt buffers and poses
# ---------------------------------------------------------------------------

def look_at(eye: np.ndarray) -> np.ndarray:
    """Camera-to-world (3, 4) at `eye` looking at the origin (-z forward,
    +y up), the convention of the port's rays."""
    z = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z, eye], axis=1).astype(np.float32)


def arc_poses(n: int, span: float, radius: float = 4.0, height: float = 0.5) -> np.ndarray:
    """n cameras on a horizontal arc of `span` radians about the origin."""
    angles = np.linspace(-span / 2, span / 2, n) if n > 1 else np.zeros(1)
    return np.stack([look_at(np.array([radius * np.sin(a), height, radius * np.cos(a)]))
                     for a in angles])


def unit_normals(gen, shape, device) -> torch.Tensor:
    """Random unit normals stored as (n + 1) / 2, as normal maps are."""
    n = torch.randn((*shape, 3), generator=gen, device=device)
    return (n / n.norm(dim=-1, keepdim=True).clamp_min(1e-6) + 1.0) * 0.5


def make_scene(args: dict, scene_cfg: dict, seed: int, device) -> dict:
    """The training arrays the port's sampler reads (images, K prefiltered
    levels, poses, intrinsics, gt normal and albedo buffers) on `device`,
    and the scene's size, focal length and depth range."""
    h, w, n = scene_cfg["height"], scene_cfg["width"], scene_cfg["train_images"]
    k = args["coarse_radiance_number"]
    gen = generator(seed, "scene", device)
    focal = 0.5 * w / math.tan(0.5 * math.radians(scene_cfg["fov_degree"]))
    poses = np.zeros((n, 4, 4), np.float32)
    poses[:, :3, :4] = arc_poses(n, scene_cfg["arc_radians"])
    poses[:, 3, 3] = 1.0
    arrays = {
        "images": torch.rand((n, h, w, 3), generator=gen, device=device),
        "poses": torch.as_tensor(poses, device=device),
        "K": torch.tensor([[focal, 0, 0.5 * w], [0, focal, 0.5 * h], [0, 0, 1]],
                          dtype=torch.float32, device=device),
    }
    if k:
        arrays["prefiltered_images"] = torch.rand((k, n, h, w, 3), generator=gen,
                                                  device=device)
    arrays["normal"] = unit_normals(gen, (n, h, w), device)
    arrays["albedo"] = torch.rand((n, h, w, 3), generator=gen, device=device)
    return {"arrays": arrays, "height": h, "width": w, "focal": focal,
            "near": scene_cfg["near"], "far": scene_cfg["far"],
            "prior_irradiance_mean": scene_cfg["prior_irradiance_mean"]}


# ---------------------------------------------------------------------------
# One update's draws
# ---------------------------------------------------------------------------

def make_draws(gen: torch.Generator, args: dict, n_rand: int, scene: dict,
               volume: bool) -> dict:
    """One update's random numbers in the shape the port's train step
    takes as `draws=`: merged pixel indices (an image per ray), the
    stratified jitter and importance uniforms, and, with the depth loss
    on, the depth-volume pass's directions and its render draws."""
    device = gen.device
    h, w = scene["height"], scene["width"]
    n_img = scene["arrays"]["images"].shape[0]
    ns, ni = args["N_samples"], args["N_importance"]

    def render(b):
        return {"strat": torch.rand((b, ns), generator=gen, device=device),
                "pdf": torch.rand((b, ni), generator=gen, device=device)}

    idx = torch.randint(0, n_img * h * w, (n_rand,), generator=gen, device=device)
    draws = {"pixels": {"img": idx // (h * w), "v": idx // w % h, "u": idx % w},
             "render": render(n_rand)}
    if volume:
        n_vol = min(args["N_depth_random_volume"], n_rand)
        draws["vol"] = {"dirs": torch.rand((n_vol, 3), generator=gen, device=device),
                        "render": render(n_vol)}
    return draws
