"""ibl_nerf_tpu_torch — the PyTorch/CUDA port of ibl_nerf_tpu.

The JAX package `ibl_nerf_tpu` is the reference; this package mirrors
its layout (`ops/`, `models/`, `kernels/`, `render/`, `data/`, `eval/`,
`train/`, `utils/`) and public names, so each module has one
counterpart there.
It imports torch and numpy only — never jax, never `ibl_nerf_tpu`.

Covered so far, in every compute mode of the JAX renderer (`float32`,
`bfloat16`, `mixed`, `bf16_grad`, `amp`, `float64`): training from a
scene directory through the CLI (`cli.train` → `train.loop.train`:
`data.dataset.load_scene` with the native PNG decoder, the prefiltered
pyramid, phase segments, checkpoints, health checks, test-set renders
to PNGs and AVI videos), evaluation through the CLIs (`cli.test` with
material editing, object insertion and mesh export; `cli.render`
trajectories; `cli.port_checkpoint`, `cli.preprocess`,
`eval.metrics`), split-sum inference rendering (`eval.render_path` →
`render.render_rays`, ε, autograd depth-gradient, sgs or gt normals,
the gt substitutions and the edit overrides, the BRDF-LUT fetch, the
reflected march and mip interpolation), and the
train step (`train.make_train_step`: single-image or merged pixel
sampling, the gradient path with random draws, the staged losses,
named-group Adam). The no-grad sweeps run on the hand-written CUDA
kernel K1 (`kernels/fused_field.py`; f32 weights in
`csrc/fused_field.cu`, bf16 weights in `csrc/fused_field_bf16.cu`, f64
weights in `csrc/fused_field_f64.cu`), the gradient-path field query on
K2/K3 (`kernels/fused_field_train.py`, `csrc/fused_field_train.cu`).
"""

__version__ = "0.1.0"
