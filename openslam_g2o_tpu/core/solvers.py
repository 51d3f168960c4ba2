"""Linear solvers for the normal equations H dx = b.

JAX replacements for the reference's LinearSolver backends
(g2o/core/linear_solver.h:41-105; g2o/solvers/{csparse,cholmod,eigen,dense,
pcg}): on an accelerator the fast paths are (a) one big dense Cholesky —
pose-graph tangent spaces up to ~2e4 dims fit comfortably in device
memory — and
(b) matrix-free block-Jacobi PCG where H is only ever applied as batched
per-edge J^T Omega J products (the reference's PCG, linear_solver_pcg.h:47,
is the closest relative; sparse Cholesky on scalar CCS structures does not
vectorize and is deliberately not reproduced).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = ["solve_dense_cholesky", "pcg_solve", "batched_small_inv",
           "batched_chol_lower", "batched_chol_inv_lower",
           "make_chebyshev_precond"]


def batched_small_inv(A):
    """Inverse of a batch of small SPD matrices.

    For D in {1, 2, 3} uses the closed-form adjugate — pure elementwise
    arithmetic that fuses, instead of a batched LU on tiny matrices
    (jnp.linalg.inv lowers small batched inverses poorly). Larger D falls
    back to jnp.linalg.inv.
    """
    D = A.shape[-1]
    if D == 1:
        return 1.0 / A
    if D == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        return jnp.stack([
            jnp.stack([d, -b], axis=-1),
            jnp.stack([-c, a], axis=-1),
        ], axis=-2) * inv_det[..., None, None]
    if D == 3:
        a = A[..., 0, 0]; b = A[..., 0, 1]; c = A[..., 0, 2]
        d = A[..., 1, 0]; e = A[..., 1, 1]; f = A[..., 1, 2]
        g = A[..., 2, 0]; h = A[..., 2, 1]; i = A[..., 2, 2]
        A11 = e * i - f * h; A12 = c * h - b * i; A13 = b * f - c * e
        A21 = f * g - d * i; A22 = a * i - c * g; A23 = c * d - a * f
        A31 = d * h - e * g; A32 = b * g - a * h; A33 = a * e - b * d
        det = a * A11 + b * A21 + c * A31
        inv_det = 1.0 / det
        adj = jnp.stack([
            jnp.stack([A11, A12, A13], axis=-1),
            jnp.stack([A21, A22, A23], axis=-1),
            jnp.stack([A31, A32, A33], axis=-1),
        ], axis=-2)
        return adj * inv_det[..., None, None]
    return jnp.linalg.inv(A)


def batched_chol_inv_lower(A):
    """L^-1 for a batch of small SPD matrices A = L L^T.

    D in {1, 2, 3} uses the closed-form scalar Cholesky + forward solve —
    pure elementwise arithmetic (the building block of the Jacobi-scaled
    CG fast path). Larger D falls back to batched cholesky + triangular
    solve.
    """
    D = A.shape[-1]
    if D == 1:
        return 1.0 / jnp.sqrt(A)
    if D == 2:
        l11 = jnp.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l22 = jnp.sqrt(A[..., 1, 1] - l21 * l21)
        m11 = 1.0 / l11
        m22 = 1.0 / l22
        m21 = -(l21 * m11) * m22
        z = jnp.zeros_like(l11)
        return jnp.stack([
            jnp.stack([m11, z], axis=-1),
            jnp.stack([m21, m22], axis=-1),
        ], axis=-2)
    if D == 3:
        l11 = jnp.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = jnp.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = jnp.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        m11 = 1.0 / l11
        m22 = 1.0 / l22
        m33 = 1.0 / l33
        m21 = -(l21 * m11) * m22
        m31 = -(l31 * m11 + l32 * m21) * m33
        m32 = -(l32 * m22) * m33
        z = jnp.zeros_like(l11)
        return jnp.stack([
            jnp.stack([m11, z, z], axis=-1),
            jnp.stack([m21, m22, z], axis=-1),
            jnp.stack([m31, m32, m33], axis=-1),
        ], axis=-2)
    L = jnp.linalg.cholesky(A)
    eye = jnp.broadcast_to(jnp.eye(D, dtype=A.dtype), A.shape)
    return jax.vmap(lambda Li, I: solve_triangular(Li, I, lower=True))(
        L.reshape((-1, D, D)), eye.reshape((-1, D, D))).reshape(A.shape)


def batched_chol_lower(A):
    """L for a batch of small SPD matrices A = L L^T (closed form for
    D <= 3, elementwise arithmetic; jnp.linalg.cholesky beyond)."""
    D = A.shape[-1]
    if D == 1:
        return jnp.sqrt(A)
    if D == 2:
        l11 = jnp.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l22 = jnp.sqrt(A[..., 1, 1] - l21 * l21)
        z = jnp.zeros_like(l11)
        return jnp.stack([
            jnp.stack([l11, z], axis=-1),
            jnp.stack([l21, l22], axis=-1),
        ], axis=-2)
    if D == 3:
        l11 = jnp.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = jnp.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = jnp.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        z = jnp.zeros_like(l11)
        return jnp.stack([
            jnp.stack([l11, z, z], axis=-1),
            jnp.stack([l21, l22, z], axis=-1),
            jnp.stack([l31, l32, l33], axis=-1),
        ], axis=-2)
    return jnp.linalg.cholesky(A)


def solve_dense_cholesky(H, b):
    """Solve H x = b by dense Cholesky. Returns (x, ok).

    On failure (H not SPD -> NaNs in the factor) ok is False and x is zeros,
    which the LM trial loop treats like the reference treats a CSparse
    failure: chi2 = inf, retry with larger lambda
    (optimization_algorithm_levenberg.cpp:119-120).
    """
    L = jnp.linalg.cholesky(H)
    y = solve_triangular(L, b, lower=True)
    x = solve_triangular(L.T, y, lower=False)
    ok = jnp.all(jnp.isfinite(x))
    return jnp.where(ok, x, jnp.zeros_like(x)), ok


def _tree_dot(a, b):
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(jnp.vdot(x, y) for x, y in zip(leaves_a, leaves_b))


def _tree_axpy(alpha, x, y):
    return jax.tree_util.tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def make_chebyshev_precond(matvec, lo, hi, degree: int):
    """Chebyshev polynomial preconditioner z = p(S) r, where p is the
    degree-(degree-1) Chebyshev approximation to S^-1 on [lo, hi].

    Built for the LATENCY-BOUND hot loop of small-block PCG: each
    outer CG iteration carries ~20 tiny-op overheads (dots, axpys, the
    while_loop sync) around one matvec. A polynomial preconditioner spends
    (degree-1) extra matvecs per outer iteration to cut the OUTER iteration
    count ~degree-fold for the same total matvec work (Chebyshev is the
    minimax-optimal fixed polynomial on an interval), so the per-iteration
    overhead amortizes across degree matvecs — the classic
    communication-avoiding trade, applied to op-dispatch latency instead of
    network latency.

    Safety: for any SPD S with spectrum in (0, hi], the Chebyshev residual
    polynomial satisfies |r_d(x)| <= 1 with equality only at x = 0, so
    p(x) = (1 - r_d(x))/x > 0 on (0, hi] — the preconditioner is SPD even
    when lo overestimates the smallest eigenvalue (it merely weakens).
    Pair with a Gershgorin hi (sparse.ell_gershgorin_bound), which can
    never underestimate.

    lo/hi may be traced scalars (the recurrence coefficients trace to
    scalar ops evaluated once per build, outside the CG while_loop).
    Implements Saad, Iterative Methods for Sparse Linear Systems, Alg 12.1.
    """
    theta = (hi + lo) * 0.5
    delta = jnp.maximum((hi - lo) * 0.5, 1e-12)
    sigma1 = theta / delta

    def apply(r):
        rho = 1.0 / sigma1
        d = jax.tree_util.tree_map(lambda ri: ri / theta, r)
        z = d
        for _ in range(degree - 1):
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            sz = matvec(z)
            d = jax.tree_util.tree_map(
                lambda di, ri, szi: rho_new * rho * di
                + (2.0 * rho_new / delta) * (ri - szi), d, r, sz)
            z = jax.tree_util.tree_map(jnp.add, z, d)
            rho = rho_new
        return z

    return apply


def pcg_solve(matvec, b, precond=None, max_iter: int = 100,
              tol: float = 1e-6, x0=None, unroll: int = 1,
              norm: str = "true"):
    """Preconditioned conjugate gradient with a fixed iteration budget.

    Matrix-free analogue of LinearSolverPCG (linear_solver_pcg.h:47-110):
    `matvec` applies H (typically as batched per-edge products + damping) and
    `precond` applies the block-Jacobi inverse. Runs as a lax.while_loop so
    it jits into a single fused program.

    Operands may be flat arrays OR pytrees of per-group parts — the pytree
    form keeps the hot loop free of gather/scatter.

    unroll: CG iterations per while_loop body. At pose-graph sizes each
    iteration is latency-bound (~30 tiny ops), so checking the tolerance
    every 2nd iteration halves the loop-carried sync overhead; the extra
    past-tolerance iteration only refines the solution. Indefiniteness stays
    sticky across the unrolled pair (alpha is gated to 0 once curvature goes
    non-positive, freezing x).

    norm: "true" stops on ||r||^2 <= tol^2 ||b||^2 (an extra reduction per
    iteration); "precond" stops on the M^-1-norm r.z <= tol^2 b.M^-1 b that
    CG already computes — one fewer global reduction in the latency-bound
    hot loop, the right choice for inexact-Newton forcing tolerances.

    Returns (x, ok).
    """
    if precond is None:
        precond = lambda r: r
    use_precond_norm = norm == "precond"
    zeros = jax.tree_util.tree_map(jnp.zeros_like, b)
    x = zeros if x0 is None else x0
    r = jax.tree_util.tree_map(lambda bi, hxi: bi - hxi, b, matvec(x))
    z = precond(r)
    p = z
    rz = _tree_dot(r, z)
    if use_precond_norm:
        r2_0 = rz
        b2 = jnp.maximum(_tree_dot(b, precond(b)), 1e-30)
    else:
        r2_0 = _tree_dot(r, r)
        b2 = jnp.maximum(_tree_dot(b, b), 1e-30)

    def cond(state):
        i, x, r, p, rz, r2, pd = state
        return jnp.logical_and(jnp.logical_and(i < max_iter, pd),
                               r2 > tol * tol * b2)

    def one_iteration(state):
        i, x, r, p, rz, r2, pd = state
        hp = matvec(p)
        denom = _tree_dot(p, hp)
        # negative/zero curvature -> the damped system is not PD; freeze x
        # (alpha gated to 0, stickily) and exit so the caller gets a failure
        # signal (the reference's failed-factorization path,
        # optimization_algorithm_levenberg.cpp:119-120) instead of a
        # silently-diverged "solution".
        pd = jnp.logical_and(pd, denom > 0)
        alpha = jnp.where(pd, rz / jnp.where(denom == 0, 1.0, denom), 0.0)
        x = _tree_axpy(alpha, p, x)
        r = _tree_axpy(-alpha, hp, r)
        z = precond(r)
        rz_new = _tree_dot(r, z)
        r2_new = rz_new if use_precond_norm else _tree_dot(r, r)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = _tree_axpy(beta, p, z)
        return i + 1, x, r, p, rz_new, r2_new, pd

    def body(state):
        for _ in range(unroll):
            state = one_iteration(state)
        return state

    _, x, r, _, _, r2, pd = jax.lax.while_loop(
        cond, body, (0, x, r, p, rz, r2_0, jnp.array(True)))
    finite = jnp.all(jnp.asarray(
        [jnp.all(jnp.isfinite(leaf)) for leaf in jax.tree_util.tree_leaves(x)]))
    # indefiniteness only fails the solve if the residual had not already met
    # the tolerance (a tiny rounding-negative denominator at convergence is
    # not a stall)
    ok = jnp.logical_and(finite,
                         jnp.logical_or(pd, r2 <= tol * tol * b2))
    x = jax.tree_util.tree_map(
        lambda xi: jnp.where(ok, xi, jnp.zeros_like(xi)), x)
    return x, ok
