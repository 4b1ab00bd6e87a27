"""Scenes (loading, resampling, the prefiltered pyramid, the native PNG
decoder), assets (the split-sum BRDF LUT) and the train step's pixel
sampler."""

from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
