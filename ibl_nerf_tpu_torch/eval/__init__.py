"""Evaluation: full-path rendering."""

from ibl_nerf_tpu_torch.eval.render_path import render_path
