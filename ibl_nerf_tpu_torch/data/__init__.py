"""Assets: the split-sum BRDF LUT."""

from ibl_nerf_tpu_torch.data.brdf_lut import load_brdf_lut
