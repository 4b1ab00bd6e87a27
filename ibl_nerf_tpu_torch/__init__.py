"""ibl_nerf_tpu_torch — the PyTorch/CUDA port of ibl_nerf_tpu.

The JAX package `ibl_nerf_tpu` is the reference; this package mirrors
its layout (`ops/`, `models/`, `kernels/`, `render/`, `data/`, `eval/`,
`utils/`) and public names, so each module has one counterpart there.
It imports torch and numpy only — never jax, never `ibl_nerf_tpu`.

Covered so far: split-sum inference rendering (`eval.render_path` →
`render.render_rays`, ε-normals, the BRDF-LUT fetch, the reflected
march and mip interpolation) in the `float32` and `bf16_grad` compute
modes, with the no-grad sweeps on the hand-written CUDA kernel K1
(`kernels/fused_field.py`, `csrc/fused_field.cu`). Modes outside that
raise NotImplementedError with the mode's name.
"""

__version__ = "0.1.0"
