"""Normal estimators: finite differences of the depth, and the density
gradient.

Counterpart of ibl_nerf_tpu/render/normals.py: the ε variants
(`normal_from_depth_gradient_epsilon`,
`normal_from_depth_gradient_direction_epsilon`), the autograd
depth-gradient variants (`normal_from_depth_gradient`,
`normal_from_depth_gradient_direction`: two forward-mode
`torch.func.jvp` of the depth render, as JAX takes two `jax.jvp`) and
the sigma-gradient variants (`normal_from_sigma_gradient`,
`normal_from_sigma_gradient_surface`).

`query_sigma` is a callable pts[..., 3] -> raw sigma[..., 1]. Every
estimator returns a normal that carries no gradient.
"""

from __future__ import annotations

import torch

from ibl_nerf_tpu_torch.ops.compositing import (
    alpha_from_sigma,
    dists_from_z_vals,
    weights_from_alpha,
)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _pixel_basis(rays_d: torch.Tensor):
    """right/up basis per ray (unnormalized, as the reference)."""
    up_world = torch.zeros_like(rays_d)
    up_world[..., 1] = 1.0
    right = torch.linalg.cross(rays_d, up_world, dim=-1)
    up = torch.linalg.cross(right, rays_d, dim=-1)
    return right, up


def _depth_from_sigma(sigma_raw, dists, z_vals):
    w = weights_from_alpha(alpha_from_sigma(sigma_raw, dists))
    return torch.sum(w * z_vals, dim=-1)


def _sweep_sigma(query_sigma, new_pts: torch.Tensor, scan: bool) -> torch.Tensor:
    """Evaluate the (4, B, S, 3) ε-offset point set -> sigma (4, B, S).

    scan=False: one batched (4B, S, 3) density query, ray axis major
    ((B, 4, ...) -> (4B, ...)), as the reference orders it.
    scan=True: the 4 offsets one after another — 4x lower activation
    peak.
    """
    if scan:
        return torch.stack([query_sigma(p)[..., 0] for p in new_pts])
    b = new_pts.shape[1]
    pts_bmajor = new_pts.transpose(0, 1).reshape(4 * b, *new_pts.shape[2:])
    sigma = query_sigma(pts_bmajor)[..., 0]
    return sigma.reshape(b, 4, -1).transpose(0, 1)


def normal_from_depth_gradient_epsilon(query_sigma, rays_o, rays_d, z_vals,
                                       epsilon: float = 0.01,
                                       scan: bool = False):
    """Finite-difference normals wrt *position* offsets."""
    right, up = _pixel_basis(rays_d)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]

    offsets = torch.stack([right, -right, up, -up], dim=0)  # (4, B, 3)
    new_pts = pts[None] + epsilon * offsets[:, :, None, :]  # (4, B, S, 3)
    sigma = _sweep_sigma(query_sigma, new_pts, scan)

    dists = dists_from_z_vals(z_vals, rays_d)
    d_r, d_l, d_u, d_d = (_depth_from_sigma(sigma[i], dists, z_vals)
                          for i in range(4))
    dx = 2 * epsilon * right + (d_r - d_l)[..., None] * rays_d
    dy = 2 * epsilon * up + (d_u - d_d)[..., None] * rays_d
    return _normalize(torch.linalg.cross(dx, dy, dim=-1))


def normal_from_depth_gradient_direction_epsilon(query_sigma, rays_o, rays_d,
                                                 z_vals, epsilon: float = 0.01,
                                                 scan: bool = False):
    """Finite-difference normals wrt *direction* offsets."""
    right, up = _pixel_basis(rays_d)
    nd = [_normalize(rays_d + epsilon * right),
          _normalize(rays_d - epsilon * right),
          _normalize(rays_d + epsilon * up),
          _normalize(rays_d - epsilon * up)]

    new_d = torch.stack(nd, dim=0)                              # (4, B, 3)
    pts = (rays_o[None, :, None, :]
           + new_d[:, :, None, :] * z_vals[None, :, :, None])   # (4, B, S, 3)
    sigma = _sweep_sigma(query_sigma, pts, scan)

    dists = dists_from_z_vals(z_vals, rays_d)
    pos = [rays_o + _depth_from_sigma(sigma[i], dists, z_vals)[..., None] * nd[i]
           for i in range(4)]
    return _normalize(torch.linalg.cross(pos[0] - pos[1], pos[2] - pos[3], dim=-1))


def _depth_gradient_normal(depth_of, rays_d, right, up):
    """normalize(right * dD/da + up * dD/db - rays_d), the two derivatives
    of `depth_of` ((B, 2) offsets -> (B,) depth) at zero offset taken by
    forward mode along the unit tangents."""
    zero = rays_d.new_zeros((*rays_d.shape[:-1], 2))
    ea, eb = torch.zeros_like(zero), torch.zeros_like(zero)
    ea[..., 0] = 1.0
    eb[..., 1] = 1.0
    _, dx = torch.func.jvp(depth_of, (zero,), (ea,))
    _, dy = torch.func.jvp(depth_of, (zero,), (eb,))
    grad = right * dx[..., None] + up * dy[..., None]
    return _normalize(grad - rays_d)


def normal_from_depth_gradient(query_sigma, rays_o, rays_d, z_vals):
    """Autograd normals wrt *position* offsets: the ray origin moves by
    a * right + b * up."""
    right, up = _pixel_basis(rays_d)
    dists = dists_from_z_vals(z_vals, rays_d)

    def depth_of(ab):
        a, b = ab[..., 0:1], ab[..., 1:2]
        new_x = rays_o + right * a + up * b
        pts = new_x[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
        return _depth_from_sigma(query_sigma(pts)[..., 0], dists, z_vals)

    return _depth_gradient_normal(depth_of, rays_d, right, up)


def normal_from_depth_gradient_direction(query_sigma, rays_o, rays_d, z_vals):
    """Autograd normals wrt *direction* offsets: the ray turns to
    a * right + b * up + sqrt(1 - a^2 - b^2) * rays_d."""
    right, up = _pixel_basis(rays_d)
    dists = dists_from_z_vals(z_vals, rays_d)

    def depth_of(ab):
        a, b = ab[..., 0:1], ab[..., 1:2]
        new_d = a * right + b * up + torch.sqrt(1.0 - a * a - b * b) * rays_d
        pts = rays_o[..., None, :] + new_d[..., None, :] * z_vals[..., :, None]
        return _depth_from_sigma(query_sigma(pts)[..., 0], dists, z_vals)

    return _depth_gradient_normal(depth_of, rays_d, right, up)


def _sigma_gradient(query_sigma, pts: torch.Tensor) -> torch.Tensor:
    """d sum(sigma) / d pts, taken with respect to a detached copy of the
    points only: no gradient reaches the params, no graph is kept. Where
    sigma carries no gradient (a freeze phase detaches it) the gradient
    is zero, as jax.grad gives through a stop_gradient."""
    p = pts.detach().requires_grad_(True)
    with torch.enable_grad():
        s = query_sigma(p).sum()
        if not s.requires_grad:
            return torch.zeros_like(p)
        (g,) = torch.autograd.grad(s, p)
    return g


def normal_from_sigma_gradient(query_sigma, pts, weights):
    """Density-gradient normals composited along the ray:
    normalize(sum_s weights * -normalize(grad sigma))."""
    n = -_normalize(_sigma_gradient(lambda p: query_sigma(p)[..., 0], pts))
    return _normalize(torch.einsum("bs,bsc->bc", weights.detach(), n))


def normal_from_sigma_gradient_surface(query_sigma, x_surface):
    """Density-gradient normals at the composited surface point."""
    g = _sigma_gradient(lambda p: query_sigma(p[..., None, :])[..., 0], x_surface)
    return -_normalize(g)
