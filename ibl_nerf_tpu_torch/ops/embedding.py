"""NeRF sinusoidal positional encoding.

Counterpart of ibl_nerf_tpu/ops/embedding.py: channel order is
[input, sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...] with
log-sampled frequency bands 2**linspace(0, multires-1, multires).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def embedding_dim(input_dim: int, num_freqs: int, include_input: bool = True) -> int:
    """Output channel count of :func:`positional_encoding`."""
    out = 2 * num_freqs * input_dim
    if include_input:
        out += input_dim
    return out


def frequency_bands(num_freqs: int, log_sampling: bool = True) -> np.ndarray:
    max_freq = num_freqs - 1
    if log_sampling:
        return 2.0 ** np.linspace(0.0, max_freq, num_freqs)
    return np.linspace(2.0**0.0, 2.0**max_freq, num_freqs)


@functools.cache
def _bands(num_freqs: int, log_sampling: bool, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """The frequency bands as a tensor, copied to the device once."""
    return torch.as_tensor(frequency_bands(num_freqs, log_sampling), dtype=dtype,
                           device=device)


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode ``x[..., d]`` into ``[..., embedding_dim(d, num_freqs)]``:
    per frequency band, sin of all d channels then cos of all d."""
    if num_freqs == 0:
        return x
    freqs = _bands(num_freqs, log_sampling, x.dtype, x.device)
    xf = x[..., None, :] * freqs[:, None]                  # (..., F, d)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
