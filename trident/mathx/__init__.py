from trident.mathx.transforms import (
    compose_trs,
    decompose_trs,
    euler_deg_to_mat3,
    look_at,
    normal_matrix,
    ortho_rh_zo,
    perspective_rh_zo,
    rotate_x,
    rotate_y,
    rotate_z,
    vulkan_flip_y,
)
from trident.mathx.quat import (
    quat_identity,
    quat_from_euler_deg,
    quat_mul,
    quat_normalize,
    quat_slerp,
    quat_to_mat3,
)

__all__ = [
    "compose_trs", "decompose_trs", "euler_deg_to_mat3", "look_at",
    "normal_matrix", "ortho_rh_zo", "perspective_rh_zo",
    "rotate_x", "rotate_y", "rotate_z", "vulkan_flip_y",
    "quat_identity", "quat_from_euler_deg", "quat_mul", "quat_normalize",
    "quat_slerp", "quat_to_mat3",
]
