"""Image quality metrics: MSE, PSNR and SSIM.

Counterpart of ibl_nerf_tpu/eval/metrics.py: per-image SSIM, PSNR and
MSE averaged over a test split. SSIM is Wang et al. 2004 with an 11x11
Gaussian window (sigma 1.5) over 'valid' positions, data_range 1, the
variances clamped at 0 and each position's value clipped to [-1, 1].
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ibl_nerf_tpu_torch.utils.device import pin_f32_matmul, resolve_device


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse(a, b), min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """SSIM of two (H, W, C) or (H, W) f32 images: the mean over channels
    and valid window positions. The window variances are taken about
    each channel's image mean, which leaves them unchanged in exact
    arithmetic and keeps flat patches from cancelling in f32.

    The window sums run as a depthwise convolution in true f32: on the
    card cuDNN must not take TF32 (`pin_f32_matmul`), since the
    E[x^2] - E[x]^2 variances cancel on flat patches; the JAX package
    measured SSIM 0.41 on buffers whose SSIM is 0.88 with bf16 operands.
    """
    if a.device.type == "cuda":
        pin_f32_matmul()
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(a.device, a.dtype)[None, None]

    def filt(x):
        # (H, W, C) -> (C, 1, H, W): each channel convolves on its own
        return F.conv2d(x.permute(2, 0, 1)[:, None], k)[:, 0]

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    # the (co)variances from each channel's deviation from its image
    # mean: the same values, with far less f32 cancellation
    ma, mb = a.mean(dim=(0, 1)), b.mean(dim=(0, 1))
    da, db = a - ma, b - mb
    fa, fb = filt(da), filt(db)
    mu_a, mu_b = fa + ma[:, None, None], fb + mb[:, None, None]
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = torch.clamp(filt(da * da) - fa * fa, min=0.0)
    sigma_bb = torch.clamp(filt(db * db) - fb * fb, min=0.0)
    sigma_ab = filt(da * db) - fa * fb
    num = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    den = (mu_aa + mu_bb + c1) * (sigma_aa + sigma_bb + c2)
    return torch.mean(torch.clamp(num / den, -1.0, 1.0))


@torch.no_grad()
def batch_metrics(preds: np.ndarray, gts: np.ndarray, device=None) -> dict:
    """Mean SSIM/PSNR/MSE over a stack of images (N, H, W, C), on
    `device` (CUDA unless named). Inputs are clipped to [0, 1], as the
    reference compares exported 8-bit PNGs."""
    device = resolve_device(device)
    s, p, m = [], [], []
    for pred, gt in zip(preds, gts):
        a = torch.clamp(torch.as_tensor(np.asarray(pred, np.float32), device=device), 0.0, 1.0)
        b = torch.clamp(torch.as_tensor(np.asarray(gt, np.float32), device=device), 0.0, 1.0)
        s.append(float(ssim(a, b)))
        p.append(float(psnr(a, b)))
        m.append(float(mse(a, b)))
    return {"ssim": float(np.mean(s)), "psnr": float(np.mean(p)),
            "mse": float(np.mean(m)),
            "per_image": {"ssim": s, "psnr": p, "mse": m}}
