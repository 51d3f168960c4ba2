"""Batched Lie-group / manifold kernels for graph optimization.

This is the JAX replacement for the reference's per-object manifold
classes (g2o/types/slam2d/se2.h, g2o/types/slam3d/se3quat.h,
g2o/types/slam3d/isometry3d_mappings.{h,cpp}, g2o/types/sim3/sim3.h).
Instead of C++ objects with virtual `oplusImpl`, every group element is a flat
parameter vector and every operation is a pure jnp function of unbatched
arguments — callers `jax.vmap` them over struct-of-array vertex tables and
`jax.jacfwd` them on tangent increments.

Conventions (chosen to reproduce the reference's error definitions bit-for-bit
in exact arithmetic, so converged chi2 is comparable):

* SE2 params: ``(x, y, theta)``; composition renormalizes theta to (-pi, pi]
  (se2.h:68-72).
* Quaternions are stored ``(qx, qy, qz, qw)`` (Eigen coeffs order, matching the
  .g2o file format for VERTEX_SE3:QUAT).
* SE3 params: ``(tx, ty, tz, qx, qy, qz, qw)``.
* "MQT" minimal vector: ``(tx, ty, tz, qx, qy, qz)`` with the quaternion
  sign-normalized so qw >= 0 (isometry3d_mappings.cpp:94-106); the missing
  qw is recovered as sqrt(max(0, 1 - |q_vec|^2)) (fromCompactQuaternion,
  isometry3d_mappings.cpp:86-92).
* se3 exp/log tangent ordering is ``(omega, upsilon)`` — rotation first —
  matching SE3Quat::exp (se3quat.h:223-258).
* Sim3 tangent is ``(omega, upsilon, sigma)`` (sim3.h:70-130).

All small-angle branches use the `where(cond, taylor, exact)` idiom with
"poisoned input" guards so both values and jacfwd derivatives are finite.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "normalize_angle",
    # SO2 / SE2
    "so2_rotmat", "se2_compose", "se2_inverse", "se2_apply",
    "se2_retract", "se2_from_vector", "se2_to_vector", "se2_error",
    # quaternion
    "quat_identity", "quat_mul", "quat_conj", "quat_normalize",
    "quat_normalize_positive", "quat_rotate", "quat_to_matrix",
    "matrix_to_quat", "quat_from_compact", "quat_to_compact",
    # SE3
    "se3_identity", "se3_compose", "se3_inverse", "se3_apply",
    "se3_retract_mqt", "se3_error_mqt", "se3_from_mqt",
    "se3_exp", "se3_log", "se3_retract_expmap_left",
    "so3_exp", "so3_log", "skew",
    # Sim3
    "sim3_identity", "sim3_exp", "sim3_log", "sim3_compose",
    "sim3_inverse", "sim3_apply", "sim3_retract_expmap_left",
]

_EPS = 1e-10


def normalize_angle(theta):
    """Wrap an angle to (-pi, pi]. Reference: g2o/stuff/misc.h:94 (normalize_theta)."""
    two_pi = 2.0 * jnp.pi
    return theta - two_pi * jnp.floor((theta + jnp.pi) / two_pi)


# ---------------------------------------------------------------------------
# SO2 / SE2  — params (x, y, theta)
# ---------------------------------------------------------------------------

def so2_rotmat(theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack([jnp.stack([c, -s]), jnp.stack([s, c])])


def se2_compose(a, b):
    """a * b (motion composition), theta renormalized. Reference se2.h:66-72."""
    ca, sa = jnp.cos(a[2]), jnp.sin(a[2])
    x = a[0] + ca * b[0] - sa * b[1]
    y = a[1] + sa * b[0] + ca * b[1]
    return jnp.stack([x, y, normalize_angle(a[2] + b[2])])


def se2_inverse(a):
    """Reference se2.h:80-90."""
    c, s = jnp.cos(a[2]), jnp.sin(a[2])
    # R(-theta) * (-t)
    x = -(c * a[0] + s * a[1])
    y = -(-s * a[0] + c * a[1])
    return jnp.stack([x, y, normalize_angle(-a[2])])


def se2_apply(a, p):
    """Transform a 2D point: t + R p. Reference se2.h:74-77."""
    c, s = jnp.cos(a[2]), jnp.sin(a[2])
    return jnp.stack([a[0] + c * p[0] - s * p[1],
                      a[1] + s * p[0] + c * p[1]])


def se2_retract(params, delta):
    """VertexSE2 oplus: additive update then renormalize theta.

    Reference: g2o/types/slam2d/vertex_se2.h:41 (oplusImpl adds (dx,dy,dth)
    to the vector and normalizes the angle).
    """
    out = params + delta
    return out.at[2].set(normalize_angle(out[2]))


def se2_from_vector(v):
    return v


def se2_to_vector(p):
    return p


def se2_error(meas_inv, xi, xj):
    """EdgeSE2 error: (Z^-1 * (Xi^-1 * Xj)).toVector(). Reference edge_se2.h:46-52."""
    return se2_compose(meas_inv, se2_compose(se2_inverse(xi), xj))


# ---------------------------------------------------------------------------
# Quaternions — (qx, qy, qz, qw)
# ---------------------------------------------------------------------------

def quat_identity(dtype=jnp.float32):
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1[0], q1[1], q1[2], q1[3]
    x2, y2, z2, w2 = q2[0], q2[1], q2[2], q2[3]
    return jnp.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_conj(q):
    return jnp.stack([-q[0], -q[1], -q[2], q[3]])


def quat_normalize(q):
    return q / jnp.linalg.norm(q)


def quat_normalize_positive(q):
    """Normalize and force qw >= 0. Reference isometry3d_mappings.cpp:38-45."""
    q = quat_normalize(q)
    return jnp.where(q[3] < 0, -q, q)


def quat_rotate(q, v):
    """Rotate vector v by unit quaternion q (q * [v,0] * q^-1), expanded form."""
    u = q[:3]
    w = q[3]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_matrix(q):
    x, y, z, w = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack([
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)]),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)]),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]),
    ])


def matrix_to_quat(R):
    """Rotation matrix -> (x,y,z,w), branch-free (selects among the four
    Shepperd constructions by largest denominator, jit/vmap-safe)."""
    t = jnp.trace(R)
    d0, d1, d2 = R[0, 0], R[1, 1], R[2, 2]

    # candidate 0: trace-based
    s_w = jnp.sqrt(jnp.maximum(1.0 + t, _EPS)) * 2.0
    q_w = jnp.stack([(R[2, 1] - R[1, 2]) / s_w,
                     (R[0, 2] - R[2, 0]) / s_w,
                     (R[1, 0] - R[0, 1]) / s_w,
                     0.25 * s_w])
    # candidate 1: x largest
    s_x = jnp.sqrt(jnp.maximum(1.0 + d0 - d1 - d2, _EPS)) * 2.0
    q_x = jnp.stack([0.25 * s_x,
                     (R[0, 1] + R[1, 0]) / s_x,
                     (R[0, 2] + R[2, 0]) / s_x,
                     (R[2, 1] - R[1, 2]) / s_x])
    # candidate 2: y largest
    s_y = jnp.sqrt(jnp.maximum(1.0 + d1 - d0 - d2, _EPS)) * 2.0
    q_y = jnp.stack([(R[0, 1] + R[1, 0]) / s_y,
                     0.25 * s_y,
                     (R[1, 2] + R[2, 1]) / s_y,
                     (R[0, 2] - R[2, 0]) / s_y])
    # candidate 3: z largest
    s_z = jnp.sqrt(jnp.maximum(1.0 + d2 - d0 - d1, _EPS)) * 2.0
    q_z = jnp.stack([(R[0, 2] + R[2, 0]) / s_z,
                     (R[1, 2] + R[2, 1]) / s_z,
                     0.25 * s_z,
                     (R[1, 0] - R[0, 1]) / s_z])

    use_trace = t > 0.0
    use_x = jnp.logical_and(~use_trace, jnp.logical_and(d0 >= d1, d0 >= d2))
    use_y = jnp.logical_and(~use_trace, jnp.logical_and(~(jnp.logical_and(d0 >= d1, d0 >= d2)), d1 >= d2))
    q = jnp.where(use_trace, q_w,
                  jnp.where(use_x, q_x, jnp.where(use_y, q_y, q_z)))
    return quat_normalize(q)


def quat_from_compact(v):
    """(qx,qy,qz) -> full quaternion with qw = sqrt(max(0, 1-|v|^2)).

    Reference fromCompactQuaternion (isometry3d_mappings.cpp:86-92). The
    reference returns identity when |v|>1; we clamp instead (same fixed point,
    smooth for autodiff).
    """
    n2 = jnp.sum(v * v)
    w = jnp.sqrt(jnp.maximum(1.0 - n2, 0.0))
    return jnp.concatenate([v, jnp.stack([w])])


def quat_to_compact(q):
    """Full quaternion -> (qx,qy,qz) with sign so qw>=0 (toCompactQuaternion)."""
    return quat_normalize_positive(q)[:3]


# ---------------------------------------------------------------------------
# SE3 — params (tx, ty, tz, qx, qy, qz, qw)
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float32):
    return jnp.array([0, 0, 0, 0, 0, 0, 1], dtype=dtype)


def se3_compose(a, b):
    t = a[:3] + quat_rotate(a[3:7], b[:3])
    q = quat_mul(a[3:7], b[3:7])
    return jnp.concatenate([t, quat_normalize(q)])


def se3_inverse(a):
    qi = quat_conj(a[3:7])
    return jnp.concatenate([-quat_rotate(qi, a[:3]), qi])


def se3_apply(a, p):
    return a[:3] + quat_rotate(a[3:7], p)


def se3_from_mqt(v):
    """(t, q_vec) -> SE3 params. Reference fromVectorMQT (isometry3d_mappings.cpp:117)."""
    return jnp.concatenate([v[:3], quat_from_compact(v[3:6])])


def se3_retract_mqt(params, delta):
    """VertexSE3 oplus: T <- T * fromVectorMQT(delta), delta = (dt, dq_vec).

    Reference vertex_se3.h:100-116. Quaternion storage makes the reference's
    periodic re-orthogonalization unnecessary — we renormalize every step.
    """
    return se3_compose(params, se3_from_mqt(delta))


def se3_error_mqt(meas_inv, xi, xj):
    """EdgeSE3 error: toVectorMQT(Z^-1 * Xi^-1 * Xj). Reference edge_se3.cpp:48-53."""
    d = se3_compose(meas_inv, se3_compose(se3_inverse(xi), xj))
    return jnp.concatenate([d[:3], quat_to_compact(d[3:7])])


def skew(v):
    z = jnp.zeros((), dtype=v.dtype)
    return jnp.stack([
        jnp.stack([z, -v[2], v[1]]),
        jnp.stack([v[2], z, -v[0]]),
        jnp.stack([-v[1], v[0], z]),
    ])


def so3_exp(omega):
    """Rodrigues. Returns a unit quaternion (x,y,z,w).

    The small-angle branch guards the *input* of sqrt (not just the output)
    so jacfwd at omega = 0 is exact and finite.
    """
    theta2 = jnp.sum(omega * omega)
    small = theta2 < 1e-12
    safe_theta = jnp.sqrt(jnp.where(small, 1.0, theta2))
    half = 0.5 * safe_theta
    # sin(theta/2)/theta with Taylor fallback 0.5 - theta^2/48
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / safe_theta)
    # cos(theta/2) with Taylor fallback 1 - theta^2/8 + theta^4/384
    w = jnp.where(small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0,
                  jnp.cos(half))
    return jnp.concatenate([k * omega, jnp.stack([w])])


def so3_log(q):
    """Unit quaternion -> rotation vector omega, |omega| in [0, pi]."""
    q = jnp.where(q[3] < 0, -q, q)
    nv2 = jnp.sum(q[:3] * q[:3])
    small = nv2 < 1e-14
    safe_nv = jnp.sqrt(jnp.where(small, 1.0, nv2))
    angle = 2.0 * jnp.arctan2(safe_nv, q[3])
    # angle/|v| -> 2/w as |v| -> 0
    k = jnp.where(small, 2.0 / jnp.maximum(q[3], 1e-12), angle / safe_nv)
    return k * q[:3]


def _so3_left_jacobian_terms(theta2):
    """Coefficients A = sin t / t, B = (1-cos t)/t^2, C = (t - sin t)/t^3,
    with Taylor fallbacks (small-angle-safe for autodiff: sqrt input guarded)."""
    small = theta2 < 1e-10
    safe_t = jnp.sqrt(jnp.where(small, 1.0, theta2))
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(safe_t) / safe_t)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(safe_t)) / (safe_t * safe_t))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe_t - jnp.sin(safe_t)) / (safe_t ** 3))
    return A, B, C


def se3_exp(xi):
    """SE3Quat::exp, tangent (omega, upsilon) — rotation FIRST (se3quat.h:223-258)."""
    omega, upsilon = xi[:3], xi[3:6]
    theta2 = jnp.sum(omega * omega)
    _, B, C = _so3_left_jacobian_terms(theta2)
    Om = skew(omega)
    V = jnp.eye(3, dtype=xi.dtype) + B * Om + C * (Om @ Om)
    q = so3_exp(omega)
    return jnp.concatenate([V @ upsilon, q])


def se3_log(p):
    """SE3Quat::log (se3quat.h:178-215): returns (omega, upsilon)."""
    omega = so3_log(p[3:7])
    theta2 = jnp.sum(omega * omega)
    Om = skew(omega)
    small = theta2 < 1e-10
    safe_t2 = jnp.where(small, 1.0, theta2)
    safe_t = jnp.sqrt(safe_t2)
    # V^-1 = I - 0.5 Om + coef * Om^2 ; coef = (1 - t/(2 tan(t/2)))/t^2
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - safe_t / (2.0 * jnp.tan(safe_t / 2.0))) / safe_t2,
    )
    V_inv = jnp.eye(3, dtype=p.dtype) - 0.5 * Om + coef * (Om @ Om)
    return jnp.concatenate([omega, V_inv @ p[:3]])


def se3_retract_expmap_left(params, delta):
    """VertexSE3Expmap oplus: T <- exp(delta) * T (types_six_dof_expmap.h:101-104)."""
    return se3_compose(se3_exp(delta), params)


# ---------------------------------------------------------------------------
# Sim3 — params (tx, ty, tz, qx, qy, qz, qw, s)
# ---------------------------------------------------------------------------

def sim3_identity(dtype=jnp.float32):
    return jnp.array([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype)


def sim3_exp(xi):
    """Sim3 from tangent (omega, upsilon, sigma). Reference sim3.h:70-130.

    R = so3_exp(omega); s = e^sigma; t = W upsilon with
    W = A*I + B*Om + C*Om^2 where (sim3.h uses A,B,C for the sigma-coupled
    series): for sigma->0, theta->0: W -> I.
    """
    omega, upsilon, sigma = xi[:3], xi[3:6], xi[6]
    s = jnp.exp(sigma)
    theta2 = jnp.sum(omega * omega)
    theta = jnp.sqrt(theta2)
    Om = skew(omega)
    Om2 = Om @ Om
    eps = 1e-5
    small_sigma = jnp.abs(sigma) < eps
    small_theta = theta < eps
    safe_sigma = jnp.where(small_sigma, 1.0, sigma)
    safe_theta = jnp.where(small_theta, 1.0, theta)
    safe_t2 = safe_theta * safe_theta

    # C = (s - 1)/sigma, -> 1 as sigma->0
    C = jnp.where(small_sigma, 1.0 + 0.5 * sigma, (s - 1.0) / safe_sigma)

    # sigma ~ 0 branch:
    A0 = jnp.where(small_theta, 0.5, (1.0 - jnp.cos(safe_theta)) / safe_t2)
    B0 = jnp.where(small_theta, 1.0 / 6.0, (safe_theta - jnp.sin(safe_theta)) / (safe_t2 * safe_theta))
    # sigma != 0 branch (sim3.h:110-130):
    #   theta ~ 0: A = ((sigma-1)s+1)/sigma^2, B = ((0.5 sigma^2 - sigma + 1) s - 1)/sigma^3
    A1t = ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    B1t = ((0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0) * s - 1.0) / (safe_sigma ** 3)
    #   general: a = s sin(t), b = s cos(t), c2 = t^2 + sigma^2
    a = s * jnp.sin(safe_theta)
    b = s * jnp.cos(safe_theta)
    c2 = safe_t2 + safe_sigma * safe_sigma
    A1g = (a * safe_sigma + (1.0 - b) * safe_theta) / (safe_theta * c2)
    B1g = (C - ((b - 1.0) * safe_sigma + a * safe_theta) / c2) / safe_t2
    A1 = jnp.where(small_theta, A1t, A1g)
    B1 = jnp.where(small_theta, B1t, B1g)

    A = jnp.where(small_sigma, A0, A1)
    B = jnp.where(small_sigma, B0, B1)

    W = C * jnp.eye(3, dtype=xi.dtype) + A * Om + B * Om2
    q = so3_exp(omega)
    t = W @ upsilon
    return jnp.concatenate([t, q, jnp.stack([s])])


def sim3_log(p):
    """Inverse of sim3_exp (reference sim3.h:150-210 log)."""
    s = p[7]
    sigma = jnp.log(s)
    omega = so3_log(p[3:7])
    theta2 = jnp.sum(omega * omega)
    theta = jnp.sqrt(theta2)
    Om = skew(omega)
    Om2 = Om @ Om
    eps = 1e-5
    small_sigma = jnp.abs(sigma) < eps
    small_theta = theta < eps
    safe_sigma = jnp.where(small_sigma, 1.0, sigma)
    safe_theta = jnp.where(small_theta, 1.0, theta)
    safe_t2 = safe_theta * safe_theta

    C = jnp.where(small_sigma, 1.0 + 0.5 * sigma, (s - 1.0) / safe_sigma)
    A0 = jnp.where(small_theta, 0.5, (1.0 - jnp.cos(safe_theta)) / safe_t2)
    B0 = jnp.where(small_theta, 1.0 / 6.0, (safe_theta - jnp.sin(safe_theta)) / (safe_t2 * safe_theta))
    A1t = ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    B1t = ((0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0) * s - 1.0) / (safe_sigma ** 3)
    a = s * jnp.sin(safe_theta)
    b = s * jnp.cos(safe_theta)
    c2 = safe_t2 + safe_sigma * safe_sigma
    A1g = (a * safe_sigma + (1.0 - b) * safe_theta) / (safe_theta * c2)
    B1g = (C - ((b - 1.0) * safe_sigma + a * safe_theta) / c2) / safe_t2
    A = jnp.where(small_sigma, A0, jnp.where(small_theta, A1t, A1g))
    B = jnp.where(small_sigma, B0, jnp.where(small_theta, B1t, B1g))

    W = C * jnp.eye(3, dtype=p.dtype) + A * Om + B * Om2
    upsilon = jnp.linalg.solve(W, p[:3])
    return jnp.concatenate([omega, upsilon, jnp.stack([sigma])])


def sim3_compose(a, b):
    """(R1,t1,s1)*(R2,t2,s2) = (R1R2, s1 R1 t2 + t1, s1 s2)."""
    t = a[7] * quat_rotate(a[3:7], b[:3]) + a[:3]
    q = quat_normalize(quat_mul(a[3:7], b[3:7]))
    return jnp.concatenate([t, q, jnp.stack([a[7] * b[7]])])


def sim3_inverse(a):
    qi = quat_conj(a[3:7])
    si = 1.0 / a[7]
    return jnp.concatenate([-si * quat_rotate(qi, a[:3]), qi, jnp.stack([si])])


def sim3_apply(a, p):
    return a[7] * quat_rotate(a[3:7], p) + a[:3]


def sim3_retract_expmap_left(params, delta, fix_scale=False):
    """VertexSim3Expmap oplus: S <- Sim3(delta) * S (types_seven_dof_expmap.h:56-64).

    delta = (omega, upsilon, sigma); when fix_scale, sigma is forced to 0.
    """
    if fix_scale:
        delta = delta.at[6].set(0.0)
    return sim3_compose(sim3_exp(delta), params)
