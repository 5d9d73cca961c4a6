from ihmr_tpu_torch.ops.collision import (
    collision_loss,
    depths_to_loss,
    nearest_face_indices,
    pair_aabb_scale,
    pair_depths_at,
    pair_depths_at_tris,
    pair_depths_fast,
    pair_indices,
    pair_parity_filter,
    pair_tris_at,
    penetration_depth,
    penetration_depth_at,
    point_triangle_closest,
    ray_parity_inside,
)
from ihmr_tpu_torch.ops.exact_collision import (
    exact_penetration_depth,
    exact_penetration_depth_reference,
    pair_depths_exact,
)
from ihmr_tpu_torch.ops.grid_sdf import build_penetration_grid, pair_depths_grid, pair_grids, trilinear_sample
from ihmr_tpu_torch.ops.nearest_centroid import nearest_centroid_reference

__all__ = [
    "build_penetration_grid",
    "collision_loss",
    "depths_to_loss",
    "exact_penetration_depth",
    "exact_penetration_depth_reference",
    "nearest_centroid_reference",
    "nearest_face_indices",
    "pair_aabb_scale",
    "pair_depths_at",
    "pair_depths_at_tris",
    "pair_depths_exact",
    "pair_depths_fast",
    "pair_depths_grid",
    "pair_grids",
    "pair_indices",
    "pair_parity_filter",
    "pair_tris_at",
    "penetration_depth",
    "penetration_depth_at",
    "point_triangle_closest",
    "ray_parity_inside",
    "trilinear_sample",
]
