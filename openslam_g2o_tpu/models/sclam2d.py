"""Sensor-calibration SLAM (sclam2d): joint estimation of robot poses, a
laser sensor offset, and differential-drive odometry parameters.

JAX re-design of g2o/types/sclam2d (types_sclam2d.cpp:42-45). The
calibration unknowns are ordinary vertices (not graph parameters), exactly as
in the reference — every edge is a hyperedge touching them.
"""
from __future__ import annotations

import jax.numpy as jnp

from openslam_g2o_tpu.core.registry import (
    VertexType, EdgeType, register_vertex_type, register_edge_type)
from openslam_g2o_tpu.ops import lie


VERTEX_ODOM_PARAMS = register_vertex_type(VertexType(
    name="odom_params",
    tag="VERTEX_ODOM_DIFFERENTIAL",
    ambient_dim=3,                 # left wheel radius, right radius, baseline
    tangent_dim=3,
    retract=lambda p, d: p + d,
    origin=lambda dtype: jnp.asarray([1.0, 1.0, 1.0], dtype=dtype),
))


def _edge_se2_sensor_calib_error(vparams, meas, pdata):
    """EdgeSE2SensorCalib: Z^-1 * ((x1*off)^-1 * x2 * off)
    (edge_se2_sensor_calib.h:45-54); slot 2 is the laser-offset SE2 vertex."""
    x1, x2, off = vparams
    s1 = lie.se2_compose(x1, off)
    s2 = lie.se2_compose(x2, off)
    return lie.se2_error(lie.se2_inverse(meas), s1, s2)


EDGE_SE2_SENSOR_CALIB = register_edge_type(EdgeType(
    name="edge_se2_sensor_calib",
    tag="EDGE_SE2_CALIB",
    vertex_types=("se2", "se2", "se2"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_sensor_calib_error,
))


def velocity_to_motion(vl, vr, dt, baseline):
    """Differential-drive kinematics: wheel velocities -> SE2 motion
    (OdomConvert::convertToMotion, odometry_measurement.cpp:95-117),
    branch-free for autodiff at vr == vl."""
    diff = vr - vl
    straight = jnp.abs(diff) < 1e-7
    safe_diff = jnp.where(straight, 1.0, diff)
    R = baseline * 0.5 * (vl + vr) / safe_diff
    w = safe_diff / baseline
    theta = jnp.where(straight, 0.0, w * dt)
    # rotation of (-icc) + icc with icc = (0, R)
    x_turn = R * jnp.sin(theta)
    y_turn = R * (1.0 - jnp.cos(theta))
    tv = 0.5 * (vr + vl)
    x = jnp.where(straight, tv * dt, x_turn)
    y = jnp.where(straight, 0.0, y_turn)
    return jnp.stack([x, y, theta])


def motion_to_velocity(x, y, theta, dt):
    """SE2 motion -> differential-drive wheel velocities under unit wheel
    radii/baseline (OdomConvert::convertToVelocity,
    odometry_measurement.cpp:59-93). Host-side numpy."""
    import numpy as np

    if abs(theta) > 1e-7:
        # circle through the displaced probe point px2=(0,10)
        c, s = np.cos(theta), np.sin(theta)
        x3, y3 = x, y
        x4, y4 = -10.0 * s + x, 10.0 * c + y
        R = (10.0 * (x3 * y4 - y3 * x4)) / (10.0 * (x3 - x4))
        w = theta / dt if abs(dt) > 1e-7 else 0.0
        vl = (2.0 * R * w - w) / 2.0
        vr = w + vl
    else:
        v = np.hypot(x, y) / dt if abs(dt) > 1e-7 else 0.0
        vl = vr = v
    return vl, vr


def closed_form_calibrate(motions):
    """Closed-form joint odometry/laser calibration (Censi et al.;
    ClosedFormCalibration::calibrate, closed_form_calibration.cpp:41-152).

    motions: iterable of (odom_motion (x, y, theta) from nominal unit
    odometry, laser_motion (x, y, theta) of the sensor, dt).
    Returns (laser_offset (x, y, theta), odom_params (r_l, r_r, b)).

    The constrained least squares min x^T M x s.t. x4^2 + x5^2 = 1 is solved
    here via the 2x2 Schur complement eigenproblem (mathematically identical
    to the reference's explicit Lagrange-multiplier quadratic, without the
    hand-expanded determinant polynomial).
    """
    import numpy as np

    motions = list(motions)
    vel = [motion_to_velocity(om[0], om[1], om[2], dt)
           for om, _, dt in motions]
    # linear LSQ for (J21, J22) = (-r_l/b, r_r/b) from the angular rates
    A = np.array([[vl * dt, vr * dt] for (vl, vr), (_, _, dt) in
                  zip(vel, motions)])
    th = np.array([lm[2] for _, lm, _ in motions])
    J21, J22 = np.linalg.lstsq(A, th, rcond=None)[0]

    M = np.zeros((5, 5))
    for (vl, vr), (_, lm, dt) in zip(vel, motions):
        o_theta = (J21 * vl + J22 * vr) * dt
        if abs(o_theta) > np.finfo(float).eps:
            sx = np.sin(o_theta) / o_theta
            sy = (1.0 - np.cos(o_theta)) / o_theta
        else:
            sx, sy = 1.0, 0.0
        half = 0.5 * dt * (-J21 * vl + J22 * vr)
        L = np.array([
            [-half * sx, 1.0 - np.cos(o_theta), np.sin(o_theta),
             lm[0], -lm[1]],
            [-half * sy, -np.sin(o_theta), 1.0 - np.cos(o_theta),
             lm[1], lm[0]]])
        M += L.T @ L
    M = 0.5 * (M + M.T)

    # min x^T M x with |(x4, x5)| = 1: u = -A^-1 B v, v = min-eigvec of the
    # Schur complement C - B^T A^-1 B
    A3 = M[:3, :3]
    B = M[:3, 3:]
    C = M[3:, 3:]
    S = C - B.T @ np.linalg.solve(A3, B)
    w, V = np.linalg.eigh(0.5 * (S + S.T))
    v = V[:, 0]
    u = -np.linalg.solve(A3, B @ v)
    x = np.concatenate([u, v])
    if x[0] < 0:
        x = -x
    laser_offset = np.array([x[1], x[2], np.arctan2(x[4], x[3])])
    odom_params = np.array([-x[0] * J21, x[0] * J22, x[0]])
    return laser_offset, odom_params


def _edge_se2_odom_calib_error(vparams, meas, pdata):
    """EdgeSE2OdomDifferentialCalib: scale wheel velocities by the estimated
    radii, convert to motion with the estimated baseline, compare to the
    relative pose (edge_se2_odom_differential_calib.h:45-63).
    measurement = (vl, vr, dt)."""
    x1, x2, params = vparams
    motion = velocity_to_motion(meas[0] * params[0], meas[1] * params[1],
                                meas[2], params[2])
    delta = lie.se2_compose(lie.se2_inverse(motion),
                            lie.se2_compose(lie.se2_inverse(x1), x2))
    return delta


EDGE_SE2_ODOM_CALIB = register_edge_type(EdgeType(
    name="edge_se2_odom_calib",
    tag="EDGE_SE2_ODOM_DIFFERENTIAL_CALIB",
    vertex_types=("se2", "se2", "odom_params"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_odom_calib_error,
))
