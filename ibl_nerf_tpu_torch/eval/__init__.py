"""Evaluation: image metrics and full-path rendering."""

from ibl_nerf_tpu_torch.eval.metrics import batch_metrics, mse, psnr, ssim
from ibl_nerf_tpu_torch.eval.render_path import render_path
