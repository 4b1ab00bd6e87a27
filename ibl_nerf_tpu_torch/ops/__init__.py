"""Pure tensor math: encoding, rays, compositing, sampling, LUT
sampling, shading (split-sum and GGX), geometry, color."""

from ibl_nerf_tpu_torch.ops.embedding import positional_encoding, embedding_dim
from ibl_nerf_tpu_torch.ops.rays import (
    get_rays_full_image,
    get_rays_for_pixels,
    get_rays_for_patches,
    neighbor_coords,
    ndc_rays,
)
from ibl_nerf_tpu_torch.ops.compositing import (
    dists_from_z_vals,
    alpha_from_sigma,
    weights_from_alpha,
    accumulate,
    composite_depth_disp_acc,
)
from ibl_nerf_tpu_torch.ops.sampling import sample_pdf, stratified_z_vals
from ibl_nerf_tpu_torch.ops.texture import grid_sample_2d, mip_interp
from ibl_nerf_tpu_torch.ops.color import (
    rgb_to_srgb,
    srgb_to_linear_np,
    linear_to_srgb_np,
    tonemap_reinhard,
    to8b,
    img2mse,
    mse2psnr,
)
from ibl_nerf_tpu_torch.ops.shading import (
    fresnel_schlick_roughness,
    ggx_distribution,
    ggx_geometry,
    schlick_fresnel,
    microfacet_brdf,
    reflect,
)
from ibl_nerf_tpu_torch.ops.geometry import (
    get_tbn,
    hemisphere_samples,
    uniform_hemisphere_samples,
    depth_to_position,
    depth_to_normal_image_space,
    pose_spherical,
)
