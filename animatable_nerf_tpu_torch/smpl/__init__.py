"""SMPL body model: raw SMPL pickles, forward LBS, and the closest point
on a mesh, for the dataset-prep tools (animatable_nerf_tpu_torch/tools/).

JAX counterpart: animatable_nerf_tpu/smpl/ (replaces the reference's
vendored smplx package and the psbody / CGAL queries of its prep tools).
"""

from .body_model import (
    SMPLX_VERTEX_IDS,
    SMPLModel,
    barycentric_interpolation,
    big_pose_vector,
    extra_joint_ids,
    load_smpl,
    smplx_forward,
    smplx_full_pose,
    smplx_lbs,
    vertices2landmarks,
)
from .point_mesh import closest_point_on_mesh
