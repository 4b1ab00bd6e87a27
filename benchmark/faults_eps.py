"""Faults planted in the port's ε-normal estimator, for the tests and the
readings that show the ε-normal cell's comparison fails them. Each
`install_*` patches the port in this process and returns the function
that undoes it.

    python3 benchmark/faults_eps.py --fault <name> --workload <cell> --seeds 1,2,3 [...]

plants one and runs `control.py` with the other arguments.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.faults import _patch  # noqa: E402


def install_one_offset_dropped():
    """The sweep queries three of the four offsets; the fourth's depth
    repeats the third's."""
    from ibl_nerf_tpu_torch.render import normals

    def sweep(query_sigma, new_pts, scan):
        sigma = torch.stack([query_sigma(p)[..., 0] for p in new_pts[:3]])
        return torch.cat([sigma, sigma[2:]])

    return _patch(normals, "_sweep_sigma", sweep)


def install_eps_doubled():
    """The offsets are 2ε."""
    from ibl_nerf_tpu_torch.render import normals

    old = normals.normal_from_depth_gradient_epsilon

    def estimate(query_sigma, rays_o, rays_d, z_vals, epsilon=0.01, scan=False):
        return old(query_sigma, rays_o, rays_d, z_vals, 2.0 * epsilon, scan)

    return _patch(normals, "normal_from_depth_gradient_epsilon", estimate)


def install_gt_normals():
    """The ground-truth normal in place of the sweep."""
    from ibl_nerf_tpu_torch.render import renderer

    old = renderer._estimate_normal

    def estimate(*args):
        return old(*args[:-1], args[-1].replace(normal_type="ground_truth"))

    return _patch(renderer, "_estimate_normal", estimate)


def install_samples_fixed():
    """The importance samples at fixed quantiles (the test path's), not at
    the update's uniforms: the fine pass the reference is held on moves."""
    from ibl_nerf_tpu_torch.render import renderer

    old = renderer.sample_pdf

    def sample(bins, weights, n_samples, det=False, u=None):
        return old(bins, weights, n_samples, det=True)

    return _patch(renderer, "sample_pdf", sample)


EPS = {"one_offset_dropped": install_one_offset_dropped, "eps_doubled": install_eps_doubled,
       "gt_normals": install_gt_normals, "samples_fixed": install_samples_fixed}


def main() -> int:
    import argparse

    from benchmark import control

    p = argparse.ArgumentParser()
    p.add_argument("--fault", required=True, choices=sorted(EPS))
    a, rest = p.parse_known_args()
    EPS[a.fault]()
    sys.argv = [control.__file__, *rest]
    return control.main()


if __name__ == "__main__":
    sys.exit(main())
