"""GICP point-with-normal alignment edges between SE3 poses.

JAX re-design of g2o/types/icp (types_icp.cpp:35-36). Measurement per
edge: (pos0, normal0, pos1, normal1). Error = T0^-1 * (T1 * pos1) - pos0
(types_icp.h:183-218).

The reference's optional plane-to-plane mode recomputes the information
matrix inside computeError each iteration (types_icp.h:226-232); here that is
the separate EDGE_V_V_GICP_PLANE type whose error is pre-whitened by the
plane-aligned square-root information (same quadratic form, expressed as a
residual transform so the per-edge information stays static — the functional
formulation of the same math).
"""
from __future__ import annotations

import jax.numpy as jnp

from openslam_g2o_tpu.core.registry import (
    EdgeType, register_edge_type)
from openslam_g2o_tpu.ops import lie


def _gicp_error(vparams, meas, pdata):
    """Edge_V_V_GICP (point-to-point): T0^-1 (T1 p1) - p0."""
    t0, t1 = vparams
    p1_world = lie.se3_apply(t1, meas[6:9])
    p1_in_0 = lie.se3_apply(lie.se3_inverse(t0), p1_world)
    return p1_in_0 - meas[0:3]


EDGE_V_V_GICP = register_edge_type(EdgeType(
    name="edge_gicp",
    tag="EDGE_V_V_GICP",
    vertex_types=("se3", "se3"),
    error_dim=3,
    measurement_dim=12,            # pos0, normal0, pos1, normal1
    error=_gicp_error,
))


def _plane_sqrt_info(normal, e: float = 0.001):
    """Square root of the plane-aligned precision: points are certain along
    the normal (weight 1/e) and uncertain in-plane (weight 1)
    (EdgeGICP::prec0/cov0, types_icp.h:127-147). Build an orthonormal frame
    with the normal as the z-axis, then scale."""
    n = normal / jnp.maximum(jnp.linalg.norm(normal), 1e-12)
    # pick the axis least aligned with n to build a tangent
    a = jnp.where(jnp.abs(n[0]) < 0.9,
                  jnp.asarray([1.0, 0.0, 0.0], dtype=n.dtype),
                  jnp.asarray([0.0, 1.0, 0.0], dtype=n.dtype))
    t1 = jnp.cross(n, a)
    t1 = t1 / jnp.maximum(jnp.linalg.norm(t1), 1e-12)
    t2 = jnp.cross(n, t1)
    R = jnp.stack([t1, t2, n])                 # rows: frame axes
    scale = jnp.asarray([1.0, 1.0, 1.0 / jnp.sqrt(e)], dtype=n.dtype)
    return scale[:, None] * R                  # sqrt(prec) * rotation


def _gicp_plane_error(vparams, meas, pdata):
    """Plane-to-plane GICP: the point-to-point residual whitened by the
    target surface's plane-aligned sqrt precision (normal0 frame)."""
    r = _gicp_error(vparams, meas, pdata)
    W = _plane_sqrt_info(meas[3:6])
    return W @ r


EDGE_V_V_GICP_PLANE = register_edge_type(EdgeType(
    name="edge_gicp_plane",
    tag="EDGE_V_V_GICP_PLANE",
    vertex_types=("se3", "se3"),
    error_dim=3,
    measurement_dim=12,
    error=_gicp_plane_error,
))


def _gicp_cam_error(vparams, meas, pdata):
    """GICP edge between stereo-camera vertices: the reference's
    gicp_sba_demo adds Edge_V_V_GICP between VertexSCam nodes (VertexSCam
    derives from VertexSE3, gicp_sba_demo.cpp:173-230); here the `cam`
    vertex carries [pose(7), intrinsics(5)] and the GICP residual reads
    the pose part."""
    return _gicp_error((vparams[0][:7], vparams[1][:7]), meas, pdata)


def _gicp_plane_cam_error(vparams, meas, pdata):
    r = _gicp_cam_error(vparams, meas, pdata)
    return _plane_sqrt_info(meas[3:6]) @ r


EDGE_V_V_GICP_CAM = register_edge_type(EdgeType(
    name="edge_gicp_cam",
    tag="EDGE_V_V_GICP_CAM",
    vertex_types=("cam", "cam"),
    error_dim=3,
    measurement_dim=12,
    error=_gicp_cam_error,
))

EDGE_V_V_GICP_PLANE_CAM = register_edge_type(EdgeType(
    name="edge_gicp_plane_cam",
    tag="EDGE_V_V_GICP_PLANE_CAM",
    vertex_types=("cam", "cam"),
    error_dim=3,
    measurement_dim=12,
    error=_gicp_plane_cam_error,
))
