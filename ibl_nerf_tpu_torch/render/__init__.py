"""Volumetric renderer with split-sum IBL shading."""

from ibl_nerf_tpu_torch.render.config import RenderConfig, EditConfig
from ibl_nerf_tpu_torch.render.renderer import (
    render_rays,
    render_image,
    make_ray_batch,
    make_frame_render_fn,
    render_frame,
)
