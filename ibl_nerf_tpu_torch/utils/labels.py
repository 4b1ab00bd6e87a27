"""Instance-label encoders.

Counterpart of ibl_nerf_tpu/utils/labels.py, vestigial in the reference
(imported by its train and test scripts, used on no live path):
colored-mask <-> label maps and the four label encodings (one-hot,
scalar, colored, random code). The mask map stays numpy; the encoders
work on tensors on the `device` they are given (CUDA unless named, as
every entry point of the port). `RandomLabelEncoder`
draws its codes from a seeded torch generator unless `codes` passes
them in (JAX draws them from `jax.random.key(seed)`), so the two
packages' encoders can hold the same codes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ibl_nerf_tpu_torch.utils.device import resolve_device


def colored_mask_to_label_map(colored_mask: np.ndarray,
                              color_list: np.ndarray) -> np.ndarray:
    """(H, W, 3) colored mask -> (H, W) int labels (first match wins
    from the end)."""
    label = np.zeros(colored_mask.shape[:-1], dtype=np.int32)
    for i in range(len(color_list)):
        label = np.where(np.all(colored_mask == color_list[i], axis=-1),
                         i, label)
    return label


def label_to_colored_label(label: torch.Tensor,
                           color_list: torch.Tensor) -> torch.Tensor:
    """(...,) int labels -> (..., 3) colors."""
    return color_list[label.long()]


class LabelEncoder:
    """Base: maps integer instance labels to a trainable-target encoding."""

    def __init__(self, label_color_list: np.ndarray, device=None):
        self.device = resolve_device(device)
        self.label_color_list = torch.as_tensor(np.asarray(label_color_list),
                                                device=self.device)
        self.label_number = len(label_color_list)

    def get_dimension(self) -> int:
        raise NotImplementedError

    def encode(self, label: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, encoded: torch.Tensor, th: float = 0.0) -> torch.Tensor:
        raise NotImplementedError

    def encoded_label_to_colored_label(self, encoded, th: float = 0.0):
        return label_to_colored_label(self.decode(encoded, th),
                                      self.label_color_list)

    def error(self, output_encoded, target_label):
        """Mean-squared error in encoded space."""
        target = self.encode(target_label)
        return torch.mean((output_encoded - target) ** 2)


class OneHotLabelEncoder(LabelEncoder):
    def get_dimension(self):
        return self.label_number

    def encode(self, label):
        return F.one_hot(label.long(), self.label_number).float()

    def decode(self, encoded, th: float = 0.0):
        return torch.argmax(encoded, dim=-1)


class ScalarLabelEncoder(LabelEncoder):
    def get_dimension(self):
        return 1

    def encode(self, label):
        return label[..., None].float() / max(self.label_number - 1, 1)

    def decode(self, encoded, th: float = 0.0):
        x = torch.clamp(encoded[..., 0], 0.0, 1.0)
        return torch.round(x * (self.label_number - 1)).int()


class ColoredLabelEncoder(LabelEncoder):
    def get_dimension(self):
        return 3

    def encode(self, label):
        return self.label_color_list[label.long()].float() / 255.0

    def decode(self, encoded, th: float = 0.0):
        colors = self.label_color_list.float() / 255.0
        d = torch.sum((encoded[..., None, :] - colors) ** 2, dim=-1)
        return torch.argmin(d, dim=-1)


class RandomLabelEncoder(LabelEncoder):
    """Random unit code per label (nearest-code decode). The codes are
    standard normal draws of `torch.Generator().manual_seed(seed)`,
    normalised, unless `codes` gives the (labels, dim) unit codes (such
    as a JAX encoder's `codes`, drawn from `jax.random.key(seed)`)."""

    def __init__(self, label_color_list, dim: int = 16, seed: int = 0,
                 device=None, codes: np.ndarray | None = None):
        super().__init__(label_color_list, device)
        self.dim = dim
        if codes is None:
            gen = torch.Generator().manual_seed(seed)
            drawn = torch.randn((self.label_number, dim), generator=gen)
            codes = drawn / torch.linalg.norm(drawn, dim=-1, keepdim=True)
        else:
            codes = torch.tensor(np.asarray(codes, np.float32))
            if codes.shape != (self.label_number, dim):
                raise ValueError(f"codes {tuple(codes.shape)}, expected "
                                 f"{(self.label_number, dim)}")
        self.codes = codes.to(self.device)

    def get_dimension(self):
        return self.dim

    def encode(self, label):
        return self.codes[label.long()]

    def decode(self, encoded, th: float = 0.0):
        d = torch.sum((encoded[..., None, :] - self.codes) ** 2, dim=-1)
        return torch.argmin(d, dim=-1)
