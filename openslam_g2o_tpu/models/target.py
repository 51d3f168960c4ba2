"""Target-tracking types: constant-velocity / static target estimation.

JAX re-design of the reference's target example types
(g2o/examples/target/targetTypes3D.hpp, targetTypes6D.hpp): Euclidean
position / velocity / position+velocity vertices, a constant-velocity
process-model ("target odometry") edge driven by accelerometer
measurements, and GPS observation edges.

The reference types have no file IO (read/write return false,
targetTypes6D.hpp:36-44); we assign tags anyway so graphs built from these
types round-trip through .g2o files — a strict superset of the reference.

Unlike the reference, where dt and the noise sigma are constructor
arguments baked into each edge object (targetTypes6D.hpp:84-101), here the
per-edge dt is stored as the 4th measurement component (struct-of-arrays:
every per-edge constant must live in the edge table).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from openslam_g2o_tpu.core.registry import (
    VertexType, EdgeType, register_vertex_type, register_edge_type)


def _zeros(n):
    return lambda dtype: jnp.zeros((n,), dtype=dtype)


# VertexPosition3D (targetTypes3D.hpp:11 / targetTypes6D.hpp:17): R^3,
# additive oplus.
VERTEX_POSITION3D = register_vertex_type(VertexType(
    name="position3d",
    tag="VERTEX_POSITION3D",
    ambient_dim=3,
    tangent_dim=3,
    retract=lambda p, d: p + d,
    origin=_zeros(3),
))

# VertexVelocity3D (targetTypes3D.hpp:44): R^3, additive oplus.
VERTEX_VELOCITY3D = register_vertex_type(VertexType(
    name="velocity3d",
    tag="VERTEX_VELOCITY3D",
    ambient_dim=3,
    tangent_dim=3,
    retract=lambda p, d: p + d,
    origin=_zeros(3),
))

# VertexPositionVelocity3D (targetTypes6D.hpp:51): R^6 = (pos, vel),
# additive oplus.
VERTEX_POSVEL3D = register_vertex_type(VertexType(
    name="posvel3d",
    tag="VERTEX_POSVEL3D",
    ambient_dim=6,
    tangent_dim=6,
    retract=lambda p, d: p + d,
    origin=_zeros(6),
))


def _target_odometry_error(vparams, meas, pdata):
    """TargetOdometry3DEdge::computeError (targetTypes6D.hpp:133-146):
    constant-velocity propagation of (pos, vel) under measured acceleration
    a = meas[:3] over dt = meas[3], compared to the next state.

    e[:3] = p_i + dt*(v_i + 0.5*dt*a) - p_j
    e[3:] = v_i + dt*a - v_j
    """
    xi, xj = vparams
    a, dt = meas[:3], meas[3]
    e_pos = xi[:3] + dt * (xi[3:] + 0.5 * dt * a) - xj[:3]
    e_vel = xi[3:] + dt * a - xj[3:]
    return jnp.concatenate([e_pos, e_vel])


def _target_odometry_init(vparams, meas, pdata, slot):
    """TargetOdometry3DEdge::initialEstimate (targetTypes6D.hpp:103-123):
    propagate the from-vertex forward (only slot 1 is initializable)."""
    if slot != 1:
        return None
    xi = np.asarray(vparams[0], dtype=np.float64)
    a, dt = np.asarray(meas[:3], dtype=np.float64), float(meas[3])
    out = xi.copy()
    out[:3] += dt * (xi[3:] + 0.5 * dt * a)
    out[3:] += dt * a
    return out


EDGE_TARGET_ODOMETRY3D = register_edge_type(EdgeType(
    name="edge_target_odometry3d",
    tag="EDGE_TARGET_ODOMETRY3D",
    vertex_types=("posvel3d", "posvel3d"),
    error_dim=6,
    measurement_dim=4,            # (ax, ay, az, dt)
    error=_target_odometry_error,
    initial_estimate=_target_odometry_init,
))


def _gps_posvel_error(vparams, meas, pdata):
    """GPSObservationEdgePositionVelocity3D::computeError
    (targetTypes6D.hpp:180-187): position components minus measurement."""
    (x,) = vparams
    return x[:3] - meas


EDGE_GPS_POSVEL3D = register_edge_type(EdgeType(
    name="edge_gps_posvel3d",
    tag="EDGE_GPS_POSVEL3D",
    vertex_types=("posvel3d",),
    error_dim=3,
    measurement_dim=3,
    error=_gps_posvel_error,
))


def _gps_position_error(vparams, meas, pdata):
    """GPSObservationPosition3DEdge::computeError (targetTypes3D.hpp:83-87)."""
    (x,) = vparams
    return x - meas


EDGE_GPS_POSITION3D = register_edge_type(EdgeType(
    name="edge_gps_position3d",
    tag="EDGE_GPS_POSITION3D",
    vertex_types=("position3d",),
    error_dim=3,
    measurement_dim=3,
    error=_gps_position_error,
))


def continuous_to_discrete(Fc: np.ndarray, Qc: np.ndarray, dt: float):
    """Van Loan discretization of a continuous-time LTI system
    (continuous_to_discrete.h:9-36): returns (Fd, Qd) from the matrix
    exponential of the doubled system [[-Fc, Qc], [0, Fc^T]] * dt.

    Host-side numpy (this feeds information matrices at graph-build time,
    exactly like the reference's use in the tracking examples).
    """
    import scipy.linalg

    Fc = np.asarray(Fc, dtype=np.float64)
    Qc = np.asarray(Qc, dtype=np.float64)
    n = Fc.shape[0]
    big_a = np.zeros((2 * n, 2 * n))
    big_a[:n, :n] = -Fc * dt
    big_a[:n, n:] = Qc * dt
    big_a[n:, n:] = Fc.T * dt
    big_b = scipy.linalg.expm(big_a)
    Fd = big_b[n:, n:].T
    Qd = Fd @ big_b[:n, n:]
    return Fd, Qd


def target_odometry_information(dt: float, noise_sigma: float) -> np.ndarray:
    """The 6x6 information matrix of TargetOdometry3DEdge's impulse process
    noise model (targetTypes6D.hpp:87-100): Q assembled from dt and sigma
    with a 1e-4 diagonal stabilizer, then inverted."""
    q = noise_sigma * noise_sigma
    dt2 = dt * dt
    Q = np.zeros((6, 6))
    for m in range(3):
        Q[m, m] = dt2 * dt2 * q / 4 + 1e-4
        Q[m + 3, m + 3] = dt2 * q + 1e-4
        Q[m, m + 3] = Q[m + 3, m] = dt * dt2 * q / 2
    return np.linalg.inv(Q)
