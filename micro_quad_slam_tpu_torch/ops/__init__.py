"""Ops of the PyTorch port: the plain tensor versions, and the wrappers of
the hand-written Hopper kernels (csrc/)."""

from micro_quad_slam_tpu_torch.ops.beams import (  # noqa: F401
    extract_beams,
    tof_filter_update,
)
from micro_quad_slam_tpu_torch.ops.raycast import (  # noqa: F401
    DEFAULT_GEOM,
    GridGeom,
    apply_scan_to_grid,
    logical_grid,
    make_rays,
    new_padded_grid,
    recenter_apply,
    recenter_decide,
    shift_origin,
    window_scan_update,
    world_to_cell,
)
