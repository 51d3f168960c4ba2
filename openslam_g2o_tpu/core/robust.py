"""Robust kernels: rho(e2) -> (rho, rho', rho'').

JAX rework of the reference's RobustKernel class hierarchy
(g2o/core/robust_kernel.h:52-78, robust_kernel_impl.cpp:65-134,
robust_kernel_factory.h): each kernel is a pure branch-free function of the
squared error that vmaps over all edges of a group at once; the registry
reproduces the names of G2O_REGISTER_ROBUST_KERNEL
(robust_kernel_impl.cpp:130-134).

The quadratic form is scaled by rho' and chi2 sums rho(e2), exactly matching
BaseEdge::robustInformation (base_edge.h:96-99) and
SparseOptimizer::activeRobustChi2 (sparse_optimizer.cpp:100-114).
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["ROBUST_KERNELS", "robustify", "NONE_ID", "kernel_id", "kernel_names"]


def _none(e2, delta):
    one = jnp.ones_like(e2)
    return e2, one, jnp.zeros_like(e2)


def _huber(e2, delta):
    """robust_kernel_impl.cpp:65-78."""
    dsqr = delta * delta
    sqrte = jnp.sqrt(jnp.maximum(e2, 1e-30))
    inlier = e2 <= dsqr
    rho0 = jnp.where(inlier, e2, 2.0 * sqrte * delta - dsqr)
    rho1 = jnp.where(inlier, 1.0, delta / sqrte)
    rho2 = jnp.where(inlier, 0.0, -0.5 * (delta / sqrte) / jnp.maximum(e2, 1e-30))
    return rho0, rho1, rho2


def _pseudo_huber(e2, delta):
    """robust_kernel_impl.cpp:80-90."""
    dsqr = delta * delta
    dsqr_reci = 1.0 / dsqr
    aux1 = dsqr_reci * e2 + 1.0
    aux2 = jnp.sqrt(aux1)
    return 2.0 * dsqr * (aux2 - 1.0), 1.0 / aux2, -0.5 * dsqr_reci / (aux2 * aux1)


def _cauchy(e2, delta):
    """robust_kernel_impl.cpp:92-101."""
    dsqr = delta * delta
    dsqr_reci = 1.0 / dsqr
    aux = dsqr_reci * e2 + 1.0
    rho1 = 1.0 / aux
    return dsqr * jnp.log(aux), rho1, -dsqr_reci * rho1 * rho1


def _saturated(e2, delta):
    """robust_kernel_impl.cpp:103-115."""
    dsqr = delta * delta
    inlier = e2 <= dsqr
    return (jnp.where(inlier, e2, dsqr),
            jnp.where(inlier, 1.0, 0.0),
            jnp.zeros_like(e2))


def _dcs(e2, delta):
    """Dynamic Covariance Scaling; delta is phi (robust_kernel_impl.cpp:117-128)."""
    scale = jnp.minimum((2.0 * delta) / (delta + e2), 1.0)
    return scale * e2 * scale, scale * scale, jnp.zeros_like(e2)


def _make_scale_delta(inner):
    """RobustKernelScaleDelta (robust_kernel_impl.h:42-61, .cpp:50-63): adapt
    a kernel designed for a fixed window (its own delta = 1) to another
    window size: rho = inner(e2 / delta^2) with rho0 *= delta^2 and
    rho2 /= delta^2. The per-edge delta is the wrapper's scaling delta."""
    def fn(e2, delta):
        dsqr = delta * delta
        r0, r1, r2 = inner(e2 / dsqr, jnp.ones_like(delta))
        return r0 * dsqr, r1, r2 / dsqr
    return fn


# Order defines the integer kernel ids used inside jitted code.
ROBUST_KERNELS = {
    "None": _none,
    "Huber": _huber,
    "PseudoHuber": _pseudo_huber,
    "Cauchy": _cauchy,
    "Saturated": _saturated,
    "DCS": _dcs,
    # ScaleDelta wrappers over each fixed-window kernel. The reference builds
    # these programmatically (RobustKernelScaleDelta takes any inner kernel,
    # robust_kernel_impl.h:42-61); with integer kernel ids the composition is
    # enumerated at registration instead.
    "ScaleDelta:Huber": _make_scale_delta(_huber),
    "ScaleDelta:PseudoHuber": _make_scale_delta(_pseudo_huber),
    "ScaleDelta:Cauchy": _make_scale_delta(_cauchy),
    "ScaleDelta:Saturated": _make_scale_delta(_saturated),
    "ScaleDelta:DCS": _make_scale_delta(_dcs),
}

NONE_ID = 0
_NAMES = list(ROBUST_KERNELS)


def kernel_id(name: str) -> int:
    if name not in ROBUST_KERNELS:
        raise ValueError(
            f"unknown robust kernel {name!r}; available: {', '.join(_NAMES)}")
    return _NAMES.index(name)


def kernel_names():
    return list(_NAMES)


def robustify(kid: int, e2, delta):
    """Apply kernel #kid (a static Python int) elementwise to squared errors."""
    fn = ROBUST_KERNELS[_NAMES[kid]]
    return fn(e2, delta)
