from benchmark.reference.plain.math.constants import constant
from benchmark.reference.plain.math.quaternion import (
    axis_angle_to_quat, bounded_quat_dist, cross, euler_to_quat,
    mat_to_quat, norm, normalize, quat_conj, quat_diff, quat_integrate, quat_inv,
    quat_mul, quat_rotate, quat_rotate_inv, quat_to_axis_angle, quat_to_mat)
from benchmark.reference.plain.math.spatial import (
    force_cross, inertia_at_point, motion_cross, skew, transform_force,
    transform_motion)
