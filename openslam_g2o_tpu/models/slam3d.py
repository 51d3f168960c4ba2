"""3D SLAM types: SE3 poses (stored as translation + quaternion), XYZ
landmarks, sensor-offset parameters, and their constraint edges.

JAX re-design of g2o/types/slam3d (types_slam3d.cpp registrations).
The reference stores estimates as Eigen::Isometry3d with periodic rotation
re-orthonormalization (vertex_se3.h:107-118); we store unit quaternions and
renormalize every retract, which is cheaper and exact. Error conventions
(MQT minimal vectors) match isometry3d_mappings.cpp:94-106 so chi2 values are
directly comparable with the reference.

The reference's Cache/CacheContainer machinery (cache.h:39-130) — per-vertex
memoization of X*offset products — is unnecessary here: those products are
recomputed inside the fused vmapped error kernel, where they cost less than
the bookkeeping to avoid them would.
"""
from __future__ import annotations

import jax.numpy as jnp

from openslam_g2o_tpu.core.registry import (
    VertexType, EdgeType, ParameterType,
    register_vertex_type, register_edge_type, register_parameter_type,
)
from openslam_g2o_tpu.ops import lie


def _rn_retract(params, delta):
    return params + delta


VERTEX_SE3 = register_vertex_type(VertexType(
    name="se3",
    tag="VERTEX_SE3:QUAT",
    ambient_dim=7,                      # (t, qx, qy, qz, qw)
    tangent_dim=6,
    retract=lie.se3_retract_mqt,        # vertex_se3.h:100-116 oplusImpl
    origin=lambda dtype: lie.se3_identity(dtype),
))

VERTEX_POINT_XYZ = register_vertex_type(VertexType(
    name="point_xyz",
    tag="VERTEX_TRACKXYZ",
    ambient_dim=3,
    tangent_dim=3,
    retract=_rn_retract,
    origin=lambda dtype: jnp.zeros(3, dtype=dtype),
    marginalizable=True,
))

PARAMS_SE3_OFFSET = register_parameter_type(ParameterType(
    name="se3_offset",
    tag="PARAMS_SE3OFFSET",
    dim=7,                              # (t, q) of the sensor mount
))

PARAMS_CAMERA_CALIB = register_parameter_type(ParameterType(
    name="camera_calib",
    tag="PARAMS_CAMERACALIB",
    dim=11,                             # (t, q) offset + fx, fy, cx, cy
    # ParameterCamera::read (parameter_camera.cpp:62-73)
))

PARAMS_STEREO_CAMERA_CALIB = register_parameter_type(ParameterType(
    name="stereo_camera_calib",
    tag="PARAMS_STEREOCAMERACALIB",
    dim=12,                             # offset + fx, fy, cx, cy, baseline
))


def _edge_se3_error(vparams, meas, pdata):
    """EdgeSE3: toVectorMQT(Z^-1 * Xi^-1 * Xj) (edge_se3.cpp:48-53)."""
    xi, xj = vparams
    return lie.se3_error_mqt(lie.se3_inverse(meas), xi, xj)


def _edge_se3_init(vparams, meas, pdata, slot):
    """edge_se3.cpp initialEstimate: to = from * Z (or from = to * Z^-1)."""
    from openslam_g2o_tpu.utils import np_lie
    if slot == 1:
        return np_lie.se3_compose(vparams[0], meas)
    return np_lie.se3_compose(vparams[1], np_lie.se3_inverse(meas))


EDGE_SE3 = register_edge_type(EdgeType(
    name="edge_se3",
    tag="EDGE_SE3:QUAT",
    vertex_types=("se3", "se3"),
    error_dim=6,
    measurement_dim=7,
    error=_edge_se3_error,
    initial_estimate=_edge_se3_init,
))


def _edge_se3_xyz_error(vparams, meas, pdata):
    """EdgeSE3PointXYZ: (X * offset)^-1 * point - z
    (edge_se3_pointxyz.cpp:98-109; w2n from parameter_se3_offset.cpp:75-80)."""
    x, pt = vparams
    (off,) = pdata
    w2n = lie.se3_inverse(lie.se3_compose(x, off))
    return lie.se3_apply(w2n, pt) - meas


EDGE_SE3_XYZ = register_edge_type(EdgeType(
    name="edge_se3_xyz",
    tag="EDGE_SE3_TRACKXYZ",
    vertex_types=("se3", "point_xyz"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se3_xyz_error,
    param_types=("se3_offset",),
))


def _project_w2i(x, cam_param, pt):
    """p = K (X * offset)^-1 pt (CacheCamera::w2i, parameter_camera.cpp:93-96).
    cam_param = (t(3), q(4), fx, fy, cx, cy)."""
    off, fx, fy, cx, cy = cam_param[:7], cam_param[7], cam_param[8], \
        cam_param[9], cam_param[10]
    pc = lie.se3_apply(lie.se3_inverse(lie.se3_compose(x, off)), pt)
    return jnp.stack([fx * pc[0] + cx * pc[2],
                      fy * pc[1] + cy * pc[2],
                      pc[2]])


def _edge_se3_depth_error(vparams, meas, pdata):
    """EdgeSE3PointXYZDepth: (u, v, z) - meas
    (edge_se3_pointxyz_depth.cpp:91-105)."""
    x, pt = vparams
    (cam,) = pdata
    p = _project_w2i(x, cam, pt)
    return jnp.stack([p[0] / p[2], p[1] / p[2], p[2]]) - meas


EDGE_PROJECT_DEPTH = register_edge_type(EdgeType(
    name="edge_se3_depth",
    tag="EDGE_PROJECT_DEPTH",
    vertex_types=("se3", "point_xyz"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se3_depth_error,
    param_types=("camera_calib",),
))


def _edge_se3_disparity_error(vparams, meas, pdata):
    """EdgeSE3PointXYZDisparity: (u, v, 1/z) - meas
    (edge_se3_pointxyz_disparity.cpp:96-121)."""
    x, pt = vparams
    (cam,) = pdata
    p = _project_w2i(x, cam, pt)
    return jnp.stack([p[0] / p[2], p[1] / p[2], 1.0 / p[2]]) - meas


EDGE_PROJECT_DISPARITY = register_edge_type(EdgeType(
    name="edge_se3_disparity",
    tag="EDGE_PROJECT_DISPARITY",
    vertex_types=("se3", "point_xyz"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se3_disparity_error,
    param_types=("camera_calib",),
))


def _edge_se3_prior_error(vparams, meas, pdata):
    """EdgeSE3Prior: toVectorMQT(Z^-1 * (X*offset)) (edge_se3_prior.cpp:94-97)."""
    (x,) = vparams
    (off,) = pdata
    n2w = lie.se3_compose(x, off)
    d = lie.se3_compose(lie.se3_inverse(meas), n2w)
    return jnp.concatenate([d[:3], lie.quat_to_compact(d[3:7])])


EDGE_SE3_PRIOR = register_edge_type(EdgeType(
    name="edge_se3_prior",
    tag="EDGE_SE3_PRIOR",
    vertex_types=("se3",),
    error_dim=6,
    measurement_dim=7,
    error=_edge_se3_prior_error,
    param_types=("se3_offset",),
))


def _edge_se3_offset_error(vparams, meas, pdata):
    """EdgeSE3Offset: toVectorMQT(Z^-1 * (Xi offi)^-1 * (Xj offj))
    (edge_se3_offset.cpp:100-103)."""
    xi, xj = vparams
    off_i, off_j = pdata
    si = lie.se3_compose(xi, off_i)
    sj = lie.se3_compose(xj, off_j)
    return lie.se3_error_mqt(lie.se3_inverse(meas), si, sj)


EDGE_SE3_OFFSET = register_edge_type(EdgeType(
    name="edge_se3_offset",
    tag="EDGE_SE3_OFFSET",
    vertex_types=("se3", "se3"),
    error_dim=6,
    measurement_dim=7,
    error=_edge_se3_offset_error,
    param_types=("se3_offset", "se3_offset"),
))
