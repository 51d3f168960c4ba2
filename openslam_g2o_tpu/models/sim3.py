"""Sim(3) types for scale-drift-aware monocular SLAM.

JAX re-design of g2o/types/sim3 (types_seven_dof_expmap.h). Storage:
``(t(3), q(4), s(1), fx, fy, cx, cy)`` = 12 params; tangent is the 7-vector
``(omega, upsilon, sigma)``. Conventions matched to the reference:

* File format carries the **tangent of the cam-to-world** Sim3 plus the
  camera intrinsics; the estimate is the world-to-cam inverse
  (types_seven_dof_expmap.cpp:59-80).
* oplus: S <- Sim3(update) * S, left multiplicative
  (types_seven_dof_expmap.h:56-64). The fix-scale variant zeroes sigma.
* EdgeSim3: error = log(Z * S1 * S2^-1), with Z stored pre-inverted on read
  (types_seven_dof_expmap.h:94-102, cpp:103-119).
* EdgeSim3ProjectXYZ: obs - cam_map(project(S * p)) using the *vertex's own*
  intrinsics (types_seven_dof_expmap.h:126-133, 70-76).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from openslam_g2o_tpu.core.registry import (
    VertexType, EdgeType, register_vertex_type, register_edge_type)
from openslam_g2o_tpu.ops import lie


def _np_sim3_exp(v):
    return np.asarray(lie.sim3_exp(jnp.asarray(np.asarray(v, dtype=np.float64))))


def _np_sim3_log(p):
    return np.asarray(lie.sim3_log(jnp.asarray(np.asarray(p, dtype=np.float64))))


def _np_sim3_inverse(p):
    return np.asarray(lie.sim3_inverse(jnp.asarray(np.asarray(p, dtype=np.float64))))


def _vertex_sim3_from_file(v):
    """7 tangent numbers (cam2world) + fx fy cx cy -> 12 params (w2c)."""
    s_c2w = _np_sim3_exp(v[:7])
    s_w2c = _np_sim3_inverse(s_c2w)
    return np.concatenate([s_w2c, v[7:11]])


def _vertex_sim3_to_file(p):
    tangent = _np_sim3_log(_np_sim3_inverse(p[:8]))
    return np.concatenate([tangent, p[8:12]])


def _sim3_retract(params, delta):
    s = lie.sim3_retract_expmap_left(params[:8], delta)
    return jnp.concatenate([s, params[8:12]])


VERTEX_SIM3 = register_vertex_type(VertexType(
    name="sim3",
    tag="VERTEX_SIM3:EXPMAP",
    ambient_dim=12,
    tangent_dim=7,
    retract=_sim3_retract,
    origin=lambda dtype: jnp.concatenate(
        [lie.sim3_identity(dtype), jnp.asarray([1, 1, 0, 0], dtype=dtype)]),
    file_dim=11,
    from_file=_vertex_sim3_from_file,
    to_file=_vertex_sim3_to_file,
))


def _edge_sim3_from_file(v):
    """7 tangent numbers (cam2world): measurement = exp(v)^-1 (cpp:103-112)."""
    return _np_sim3_inverse(_np_sim3_exp(v[:7]))


def _edge_sim3_to_file(m):
    return _np_sim3_log(_np_sim3_inverse(m))


def _edge_sim3_error(vparams, meas, pdata):
    """log(Z * S1 * S2^-1) (types_seven_dof_expmap.h:94-102)."""
    s1, s2 = vparams[0][:8], vparams[1][:8]
    err = lie.sim3_compose(meas, lie.sim3_compose(s1, lie.sim3_inverse(s2)))
    return lie.sim3_log(err)


EDGE_SIM3 = register_edge_type(EdgeType(
    name="edge_sim3",
    tag="EDGE_SIM3:EXPMAP",
    vertex_types=("sim3", "sim3"),
    error_dim=7,
    measurement_dim=8,
    error=_edge_sim3_error,
    file_meas_dim=7,
    from_file=_edge_sim3_from_file,
    to_file=_edge_sim3_to_file,
))


def _edge_sim3_xyz_error(vparams, meas, pdata):
    """EdgeSim3ProjectXYZ: obs - cam_map(project(S * p)); slot 0 = point
    (types_seven_dof_expmap.h:126-133)."""
    point, v = vparams
    s, fx, fy, cx, cy = v[:8], v[8], v[9], v[10], v[11]
    pc = lie.sim3_apply(s, point)
    return meas - jnp.stack([pc[0] / pc[2] * fx + cx, pc[1] / pc[2] * fy + cy])


EDGE_SIM3_XYZ = register_edge_type(EdgeType(
    name="edge_sim3_xyz",
    tag="EDGE_PROJECT_SIM3_XYZ:EXPMAP",
    vertex_types=("sba_point_xyz", "sim3"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_sim3_xyz_error,
))
