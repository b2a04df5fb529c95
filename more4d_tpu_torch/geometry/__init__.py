from .cameras import TRAJECTORY_TYPES, generate_trajectory, \
    get_trajectory_generator
from .gaussians import gs_render, gs_render_video
from .normalize import (first_frame_normalize, inverse_flow_norm,
                        inverse_normalize_with_depth, normalize_with_depth)
from .projection import (back_project_coords, get_intrinsic_matrix,
                         homogenize_points, project)
from .render import zbuffer_render, zbuffer_render_sweep, \
    zbuffer_render_video

__all__ = [
    "TRAJECTORY_TYPES", "generate_trajectory", "get_trajectory_generator",
    "gs_render", "gs_render_video", "first_frame_normalize", "inverse_flow_norm",
    "inverse_normalize_with_depth", "normalize_with_depth",
    "back_project_coords", "get_intrinsic_matrix",
    "homogenize_points", "project", "zbuffer_render", "zbuffer_render_sweep",
    "zbuffer_render_video",
]
