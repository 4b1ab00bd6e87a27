"""Scenes (loading, resampling, the prefiltered pyramid, the native PNG
decoder), assets (the split-sum BRDF LUT) and the train step's pixel
sampler."""

from ibl_nerf_tpu_torch.data.dataset import SceneData, load_scene
from ibl_nerf_tpu_torch.data.pyramid import build_prefiltered_pyramid
from ibl_nerf_tpu_torch.data.sampler import device_arrays_from_scene, sample_pixel_batch
from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
