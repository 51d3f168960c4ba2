"""2D SLAM types: SE2 poses, XY landmarks, and their constraint edges.

JAX re-design of g2o/types/slam2d (types_slam2d.cpp registrations):
each type is a declarative record of pure batched functions instead of a
BaseVertex/BaseEdge subclass. Tags match the .g2o file format so all bundled
2D datasets load directly.
"""
from __future__ import annotations

import jax.numpy as jnp

from openslam_g2o_tpu.core.registry import (
    VertexType, EdgeType, ParameterType,
    register_vertex_type, register_edge_type, register_parameter_type,
)
from openslam_g2o_tpu.ops import lie


# ---------------------------------------------------------------------------
# Vertices
# ---------------------------------------------------------------------------

def _rn_retract(params, delta):
    return params + delta


VERTEX_SE2 = register_vertex_type(VertexType(
    name="se2",
    tag="VERTEX_SE2",
    ambient_dim=3,
    tangent_dim=3,
    retract=lie.se2_retract,           # vertex_se2.h:41 oplusImpl
    origin=lambda dtype: jnp.zeros(3, dtype=dtype),
))

VERTEX_XY = register_vertex_type(VertexType(
    name="point_xy",
    tag="VERTEX_XY",
    ambient_dim=2,
    tangent_dim=2,
    retract=_rn_retract,               # vertex_point_xy.h oplusImpl (additive)
    origin=lambda dtype: jnp.zeros(2, dtype=dtype),
    marginalizable=True,
))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

PARAMS_SE2_OFFSET = register_parameter_type(ParameterType(
    name="se2_offset",
    tag="PARAMS_SE2OFFSET",
    dim=3,                             # (x, y, theta) sensor offset pose
))


# ---------------------------------------------------------------------------
# Edges
# ---------------------------------------------------------------------------

def _edge_se2_error(vparams, meas, pdata):
    """EdgeSE2: (Z^-1 * (Xi^-1 Xj)).toVector() (edge_se2.h:46-52)."""
    xi, xj = vparams
    return lie.se2_error(lie.se2_inverse(meas), xi, xj)


def _edge_se2_init(vparams, meas, pdata, slot):
    """edge_se2.cpp initialEstimate: to = from * Z (or from = to * Z^-1)."""
    from openslam_g2o_tpu.utils import np_lie
    if slot == 1:
        return np_lie.se2_compose(vparams[0], meas)
    return np_lie.se2_compose(vparams[1], np_lie.se2_inverse(meas))


def _edge_se2_jacobian(vparams, meas, pdata):
    """Analytic linearizeOplus of EdgeSE2 (edge_se2.h:89, edge_se2.cpp):
    with r = R(ti)^T (tj - ti), e_xy = R(z)^T (r - t_z):
      de_xy/dti = -Rz^T Ri^T,  de_xy/dtj = Rz^T Ri^T,
      de_xy/dthi = Rz^T (r_y, -r_x),  de_th/dthi = -1, de_th/dthj = +1.
    The se2 retract is additive (+ angle normalization), so these are also
    the tangent-increment Jacobians the solver needs. ~5x cheaper than the
    jacfwd default on the Manhattan hot path; equivalence is tested against
    jacfwd in tests/test_jacobians.py.
    """
    xi, xj = vparams
    ci, si = jnp.cos(xi[2]), jnp.sin(xi[2])
    cz, sz = jnp.cos(meas[2]), jnp.sin(meas[2])
    dx, dy = xj[0] - xi[0], xj[1] - xi[1]
    rx = ci * dx + si * dy
    ry = -si * dx + ci * dy
    # Rz^T Ri^T
    rr00 = cz * ci - sz * si
    rr01 = cz * si + sz * ci
    rr10 = -(sz * ci + cz * si)
    rr11 = -sz * si + cz * ci
    # Rz^T (ry, -rx)
    g0 = cz * ry - sz * rx
    g1 = -(sz * ry + cz * rx)
    zero = jnp.zeros_like(ci)
    one = jnp.ones_like(ci)
    ji = jnp.stack([
        jnp.stack([-rr00, -rr01, g0]),
        jnp.stack([-rr10, -rr11, g1]),
        jnp.stack([zero, zero, -one]),
    ])
    jj = jnp.stack([
        jnp.stack([rr00, rr01, zero]),
        jnp.stack([rr10, rr11, zero]),
        jnp.stack([zero, zero, one]),
    ])
    return ji, jj


EDGE_SE2 = register_edge_type(EdgeType(
    name="edge_se2",
    tag="EDGE_SE2",
    vertex_types=("se2", "se2"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_error,
    jacobian=_edge_se2_jacobian,
    initial_estimate=_edge_se2_init,
))


def _edge_se2_xy_error(vparams, meas, pdata):
    """EdgeSE2PointXY: (X^-1 * l) - z (edge_se2_pointxy.h computeError)."""
    x, l = vparams
    return lie.se2_apply(lie.se2_inverse(x), l) - meas


def _edge_se2_xy_init(vparams, meas, pdata, slot):
    """edge_se2_pointxy.cpp initialEstimate: landmark = X * z (pose slot
    cannot be initialized from a single bearing+range observation)."""
    from openslam_g2o_tpu.utils import np_lie
    if slot == 1:
        return np_lie.se2_apply(vparams[0], meas)
    return None


EDGE_SE2_XY = register_edge_type(EdgeType(
    name="edge_se2_xy",
    tag="EDGE_SE2_XY",
    vertex_types=("se2", "point_xy"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_se2_xy_error,
    initial_estimate=_edge_se2_xy_init,
))


def _edge_se2_bearing_error(vparams, meas, pdata):
    """EdgeSE2PointXYBearing: bearing of landmark in robot frame minus z
    (edge_se2_pointxy_bearing.h computeError)."""
    x, l = vparams
    d = lie.se2_apply(lie.se2_inverse(x), l)
    return jnp.stack([lie.normalize_angle(jnp.arctan2(d[1], d[0]) - meas[0])])


EDGE_BEARING_SE2_XY = register_edge_type(EdgeType(
    name="edge_se2_xy_bearing",
    tag="EDGE_BEARING_SE2_XY",
    vertex_types=("se2", "point_xy"),
    error_dim=1,
    measurement_dim=1,
    error=_edge_se2_bearing_error,
))


def _edge_se2_prior_error(vparams, meas, pdata):
    """EdgeSE2Prior: (Z^-1 * X).toVector() (edge_se2_prior.h computeError)."""
    (x,) = vparams
    return lie.se2_to_vector(lie.se2_compose(lie.se2_inverse(meas), x))


EDGE_PRIOR_SE2 = register_edge_type(EdgeType(
    name="edge_se2_prior",
    tag="EDGE_PRIOR_SE2",
    vertex_types=("se2",),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_prior_error,
))


def _edge_prior_se2_xy_error(vparams, meas, pdata):
    """EdgePointXYPrior-style unary position prior on an SE2 translation."""
    (x,) = vparams
    return x[:2] - meas


EDGE_PRIOR_SE2_XY = register_edge_type(EdgeType(
    name="edge_se2_prior_xy",
    tag="EDGE_PRIOR_SE2_XY",
    vertex_types=("se2",),
    error_dim=2,
    measurement_dim=2,
    error=_edge_prior_se2_xy_error,
))


def _edge_se2_xy_calib_error(vparams, meas, pdata):
    """EdgeSE2PointXYCalib: ((X * C)^-1 * l) - z with the calibration pose C
    as a third vertex (edge_se2_pointxy_calib.h:46-52)."""
    x, l, calib = vparams
    sensor = lie.se2_compose(x, calib)
    return lie.se2_apply(lie.se2_inverse(sensor), l) - meas


EDGE_SE2_XY_CALIB = register_edge_type(EdgeType(
    name="edge_se2_xy_calib",
    tag="EDGE_SE2_XY_CALIB",
    vertex_types=("se2", "point_xy", "se2"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_se2_xy_calib_error,
))


def _edge_se2_offset_error(vparams, meas, pdata):
    """EdgeSE2Offset: relative measurement between two sensor frames mounted
    on the poses with per-edge SE2 offset parameters
    (edge_se2_offset.cpp computeError via CacheSE2Offset)."""
    xi, xj = vparams
    off_i, off_j = pdata
    si = lie.se2_compose(xi, off_i)
    sj = lie.se2_compose(xj, off_j)
    return lie.se2_error(lie.se2_inverse(meas), si, sj)


EDGE_SE2_OFFSET = register_edge_type(EdgeType(
    name="edge_se2_offset",
    tag="EDGE_SE2_OFFSET",
    vertex_types=("se2", "se2"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_offset_error,
    param_types=("se2_offset", "se2_offset"),
))


def _edge_se2_pointxy_offset_error(vparams, meas, pdata):
    """EdgeSE2PointXYOffset: landmark seen from an offset sensor frame
    (edge_se2_pointxy_offset.cpp)."""
    x, l = vparams
    (off,) = pdata
    sensor = lie.se2_compose(x, off)
    return lie.se2_apply(lie.se2_inverse(sensor), l) - meas


EDGE_SE2_POINTXY_OFFSET = register_edge_type(EdgeType(
    name="edge_se2_xy_offset",
    tag="EDGE_SE2_POINTXY_OFFSET",
    vertex_types=("se2", "point_xy"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_se2_pointxy_offset_error,
    param_types=("se2_offset",),
))
