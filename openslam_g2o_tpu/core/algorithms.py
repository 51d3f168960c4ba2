"""Outer nonlinear least-squares iteration strategies: Gauss-Newton,
Levenberg-Marquardt (dense and matrix-free PCG variants), and Dogleg —
all in this module.

Functional re-design of g2o's OptimizationAlgorithm hierarchy
(g2o/core/optimization_algorithm.h:47, optimization_algorithm_gauss_newton.cpp
:50-90, optimization_algorithm_levenberg.cpp:57-190): the reference mutates
vertex estimates in place and uses per-vertex push/pop backup stacks for LM
trial steps (base_vertex.h:96-99); here a step is a pure function
state -> state over a parameter pytree, so the "backup stack" is simply
keeping the old pytree, and the LM trial loop is a lax.while_loop that jits
into one fused device program.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from openslam_g2o_tpu.core import problem as problem_mod
from openslam_g2o_tpu.core.problem import (
    Problem, apply_update, build_dense_system, linearize, robust_chi2,
    tangent_masks,
)
from openslam_g2o_tpu.core.solvers import solve_dense_cholesky

__all__ = ["GaussNewton", "LevenbergMarquardt", "LevenbergMarquardtPCG",
           "Dogleg", "DoglegPCG", "optimize", "TerminateCriterion"]

# Lower edge of the Chebyshev spectral bracket, as a fraction of the
# Gershgorin upper bound of the Jacobi-SCALED system. The scaled system has
# unit diagonal blocks, so its spectrum clusters near 1 with hi typically
# 2-8; lambda_min can sit far below lo (late-LM small-lambda systems do),
# which only WEAKENS the preconditioner — it stays SPD for any lo > 0
# (make_chebyshev_precond docstring). 0.02 measured best on the bundled 2D
# pose graphs at degrees 3-4; raise it for better-conditioned systems,
# lower it when late-stage iteration counts matter more than early ones.
_CHEBY_LO_FRAC = 0.02


# ---------------------------------------------------------------------------
# Gauss-Newton
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def _gn_step(prob: Problem, params: dict):
    """One GN iteration (optimization_algorithm_gauss_newton.cpp:50-90):
    linearize, solve H dx = b, retract."""
    work = prob.with_params(params)
    H, b, _ = build_dense_system(work)
    dx, ok = solve_dense_cholesky(H, b)
    new_params = apply_update(work, dx)
    chi = robust_chi2(work, new_params)
    return new_params, chi, ok


class GaussNewton:
    """Stateless GN algorithm driver."""

    name = "gn"

    def init(self, prob: Problem):
        return {"params": prob.params}

    def step(self, prob: Problem, state: dict):
        params, chi, ok = _gn_step(prob, state["params"])
        return {"params": params}, {"chi2": float(chi), "ok": bool(ok)}


# ---------------------------------------------------------------------------
# Levenberg-Marquardt
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_trials",))
def _lm_step(prob: Problem, params: dict, lam, ni, chi_cur, max_trials: int = 10):
    """One LM outer iteration with the trial while_loop.

    Semantics follow optimization_algorithm_levenberg.cpp:57-147: damping adds
    lambda to the Hessian diagonal (block_solver.hpp:564-589), gain ratio
    rho = (chi - chi_new) / (dx . (lambda dx + b) + 1e-3), accept scales
    lambda by clamp(1-(2 rho-1)^3, [1/3, 2/3]) and resets ni=2; reject scales
    lambda by ni and doubles ni.
    """
    work = prob.with_params(params)
    lin = linearize(work)
    H, b, raw_diag = build_dense_system(work, lin=lin)
    free_t, _ = tangent_masks(work)
    eye_free = jnp.diag(free_t)

    def trial_cond(st):
        trials, done, rho, lam, ni, _, _ = st[:7]
        return jnp.logical_and(jnp.logical_not(done),
                               jnp.logical_and(rho < 0, trials < max_trials))

    def trial_body(st):
        trials, done, rho, lam, ni, best_params, best_chi = st
        dx, ok = solve_dense_cholesky(H + lam * eye_free, b)
        cand = apply_update(work, dx)
        chi_new = robust_chi2(work, cand)
        # a NON-FINITE trial chi2 (divergent retraction, inf-inf in an
        # angle wrap) must behave exactly like a failed solve: rho is
        # pinned NEGATIVE so the while_loop retries with larger lambda —
        # a NaN rho would fail BOTH the accept test and the rho<0 retry
        # condition and silently end the trial loop (round-5 review)
        solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
        chi_new = jnp.where(solved, chi_new, jnp.inf)
        scale = jnp.dot(dx, lam * dx + b) + 1e-3
        rho = jnp.where(solved, (chi_cur - chi_new) / scale, -1.0)
        accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))

        alpha = 1.0 - (2.0 * rho - 1.0) ** 3
        good_scale = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
        lam = jnp.where(accept, lam * good_scale, lam * ni)
        ni = jnp.where(accept, 2.0, ni * 2.0)
        best_params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), cand, best_params)
        best_chi = jnp.where(accept, chi_new, best_chi)
        return trials + 1, accept, rho, lam, ni, best_params, best_chi

    init = (jnp.int32(0), jnp.array(False), jnp.array(-1.0, prob.dtype),
            lam, ni, params, chi_cur)
    trials, accepted, rho, lam, ni, best_params, best_chi = jax.lax.while_loop(
        trial_cond, trial_body, init)
    return best_params, lam, ni, best_chi, trials, accepted, raw_diag


@jax.jit
def _lambda_init(prob: Problem, params: dict, tau):
    """tau * max |diag(H)| (optimization_algorithm_levenberg.cpp:149-163)."""
    work = prob.with_params(params)
    _, _, raw_diag = build_dense_system(work)
    return tau * jnp.max(jnp.abs(raw_diag))


class LevenbergMarquardt:
    """LM algorithm driver. Properties mirror the reference's
    (initialLambda, maxTrialsAfterFailure — optimization_algorithm_levenberg
    .cpp:47-48)."""

    name = "lm"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5):
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau

    def init(self, prob: Problem):
        if self.initial_lambda > 0:
            lam = jnp.asarray(self.initial_lambda, prob.dtype)
        else:
            lam = _lambda_init(prob, prob.params, jnp.asarray(self.tau, prob.dtype))
        chi = robust_chi2(prob)
        return {
            "params": prob.params,
            "lam": lam,
            "ni": jnp.asarray(2.0, prob.dtype),
            "chi2": chi,
        }

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted, _ = _lm_step(
            prob, state["params"], state["lam"], state["ni"], state["chi2"],
            max_trials=self.max_trials)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {
            "chi2": float(chi),
            "lambda": float(lam),
            "levenberg_iters": int(trials),
            "ok": bool(accepted),
        }
        return new_state, info


# ---------------------------------------------------------------------------
# Levenberg-Marquardt with matrix-free PCG
# ---------------------------------------------------------------------------

def _pcg_precomp(work, pattern):
    """Per-linearization quantities of the LM-PCG trial pipeline (shared
    by the while-loop step and the loop-free trial-per-iteration fused
    body): hot-form assembled values (DIA-direct where the pattern
    activates it — sparse.assemble_hot), diagonal blocks, lane-major rhs,
    hoisted transposed index tables."""
    from openslam_g2o_tpu.core.sparse import assemble_hot, hot_diag_blocks

    lin = linearize(work)
    hot, b = assemble_hot(work, pattern, lin)
    return {
        "diag_blocks": hot_diag_blocks(work, pattern, hot),
        "bT": {k: v.T for k, v in b.items()},
        "eyes": {g.name: jnp.eye(g.tangent_dim, dtype=work.dtype)
                 for g in work.static.vgroups},
        "nbT": tuple(pattern.nb_idx[p].T
                     for p in range(len(pattern.pairs))),
        "self_maskT": tuple(None if m is None else m.T
                            for m in pattern.self_mask),
        "hot": hot,
    }


def _pcg_trial(work, pattern, pre, lam, dx0T, pcg_iters, pcg_tol,
               pcg_cheby):
    """One damped Jacobi-scaled-PCG solve on the precomputed system:
    the _lm_pcg_step trial pipeline without the LM bookkeeping. Returns
    (dxT lane-major, ok)."""
    from openslam_g2o_tpu.core.sparse import (
        ell_matvec_lane_kmajor_hot, hot_add_diag, hot_gershgorin_bound,
        hot_scale_jacobi, hot_split, lane_block_mv)
    from openslam_g2o_tpu.core.solvers import (
        batched_chol_inv_lower, batched_chol_lower, make_chebyshev_precond,
        pcg_solve)

    diag_blocks, bT, eyes = pre["diag_blocks"], pre["bT"], pre["eyes"]
    extra = {g.name: lam * work.free[g.name] + (1.0 - work.free[g.name])
             for g in work.static.vgroups}
    damped = hot_add_diag(work, pattern, pre["hot"], extra,
                          self_maskT=pre["self_maskT"])
    dblocks = {name: diag_blocks[name]
               + extra[name][:, None, None] * eyes[name][None]
               for name in diag_blocks}
    linv = {name: batched_chol_inv_lower(dblocks[name])
            for name in dblocks}
    svals = hot_scale_jacobi(work, pattern, damped, linv, nbT=pre["nbT"])
    split = hot_split(work, pattern, svals)
    linv_lane = {name: jnp.moveaxis(linv[name], 0, -1)
                 for name in linv}                     # [D, D, N]
    bhatT = lane_block_mv(linv_lane, bT)               # Linv b
    mv = lambda xT: ell_matvec_lane_kmajor_hot(work, pattern, split, xT)
    if dx0T is not None:
        lchol = {name: jnp.moveaxis(batched_chol_lower(dblocks[name]),
                                    0, -1) for name in dblocks}
        x0hat = lane_block_mv(lchol, dx0T, transpose=True)   # L^T dx0
    else:
        x0hat = None
    if pcg_cheby > 1:
        hi = hot_gershgorin_bound(work, pattern, svals)
        pre_c = make_chebyshev_precond(mv, hi * _CHEBY_LO_FRAC, hi,
                                       pcg_cheby)
        xhat, ok = pcg_solve(mv, bhatT, precond=pre_c,
                             max_iter=max(pcg_iters // pcg_cheby, 1),
                             tol=pcg_tol, unroll=1, norm="precond",
                             x0=x0hat)
    else:
        xhat, ok = pcg_solve(mv, bhatT, max_iter=pcg_iters,
                             tol=pcg_tol, unroll=2, norm="precond",
                             x0=x0hat)
    return lane_block_mv(linv_lane, xhat, transpose=True), ok


@partial(jax.jit, static_argnames=("max_trials", "pcg_iters", "pcg_tol",
                                   "pcg_cheby"))
def _lm_pcg_step(prob: Problem, pattern, params: dict, lam, ni, chi_cur,
                 dx0T=None, max_trials: int = 10, pcg_iters: int = 150,
                 pcg_tol: float = 1e-8, pcg_cheby: int = 0):
    """LM iteration solving H dx = b by block-ELL matrix-free PCG.

    The Hessian lives in the block-ELL layout (core/sparse.py): assembly is
    gather-only per LM iteration, and each PCG matvec is pure gather +
    elementwise multiply-reduce, with no scatter in the hot loop. The
    inexact step is safe: the gain-ratio test rejects bad
    steps exactly like the reference treats a failed linear solve
    (optimization_algorithm_levenberg.cpp:119-120; PCG backend
    linear_solver_pcg.h:47-110).

    dx0T: optional lane-major warm start (the previous step's accepted dx) —
    near the basin consecutive Newton systems are close, so warm-started CG
    reaches much deeper per LM iteration; used by the polish phase. Returns
    a 7-tuple ending with the accepted step's dxT for threading.

    pcg_cheby > 1 wraps the Jacobi-scaled CG in a degree-(pcg_cheby-1)
    Chebyshev polynomial preconditioner bracketed by the Gershgorin bound
    of the scaled system — ~pcg_cheby-fold fewer outer CG iterations for
    the same matvec work, amortizing the latency-bound per-iteration
    overhead (solvers.make_chebyshev_precond). pcg_iters keeps counting
    MATVECS: each outer iteration costs exactly pcg_cheby matvecs (1 for
    the A-apply + pcg_cheby-1 inside the degree-(pcg_cheby-1) polynomial
    apply), so the internal outer budget pcg_iters // pcg_cheby holds the
    loop's matvec total to ~pcg_iters (+1 preconditioner application on
    the initial residual, outside the loop).
    """
    from openslam_g2o_tpu.core.problem import apply_update_parts
    from openslam_g2o_tpu.core.solvers import _tree_dot

    work = prob.with_params(params)
    # per-linearization precompute: everything lane-/K-major, transposes
    # hoisted out of the trial and CG loops (_pcg_precomp); per trial,
    # damping folds into the ELL values and the whole system is
    # symmetrically scaled by the damped diagonal's inverse Cholesky
    # factors (split-form block-Jacobi, _pcg_trial). A non-SPD damped
    # diagonal yields NaN factors -> ok False -> lambda retry, the
    # reference's failed-factorization semantics.
    pre = _pcg_precomp(work, pattern)
    bT = pre["bT"]

    def trial_cond(st):
        trials, done, rho = st[0], st[1], st[2]
        return jnp.logical_and(jnp.logical_not(done),
                               jnp.logical_and(rho < 0, trials < max_trials))

    def trial_body(st):
        trials, done, rho, lam, ni, best_params, best_chi, best_dxT = st
        dxT, ok = _pcg_trial(work, pattern, pre, lam, dx0T, pcg_iters,
                             pcg_tol, pcg_cheby)
        dx = {k: v.T for k, v in dxT.items()}
        cand = apply_update_parts(work, dx)
        chi_new = robust_chi2(work, cand)
        # non-finite trial chi2 behaves like a failed solve: rho pinned
        # negative so the loop RETRIES (a NaN rho would end it — see
        # _lm_step)
        solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
        chi_new = jnp.where(solved, chi_new, jnp.inf)
        scale = _tree_dot(dxT, jax.tree_util.tree_map(
            lambda d, bi: lam * d + bi, dxT, bT)) + 1e-3
        rho = jnp.where(solved, (chi_cur - chi_new) / scale, -1.0)
        accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))
        alpha = 1.0 - (2.0 * rho - 1.0) ** 3
        good_scale = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
        lam = jnp.where(accept, lam * good_scale, lam * ni)
        ni = jnp.where(accept, 2.0, ni * 2.0)
        best_params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), cand, best_params)
        best_dxT = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), dxT, best_dxT)
        best_chi = jnp.where(accept, chi_new, best_chi)
        return trials + 1, accept, rho, lam, ni, best_params, best_chi, \
            best_dxT

    zerosT = {g.name: jnp.zeros((g.tangent_dim, g.count), prob.dtype)
              for g in prob.static.vgroups}
    init = (jnp.int32(0), jnp.array(False), jnp.array(-1.0, prob.dtype),
            lam, ni, params, chi_cur, zerosT)
    # peel the FIRST trial out of the while_loop: the loop body then only
    # runs on lambda retries
    first = trial_body(init)
    (trials, accepted, rho, lam, ni, best_params, best_chi,
     best_dxT) = jax.lax.while_loop(trial_cond, trial_body, first)
    return best_params, lam, ni, best_chi, trials, accepted, best_dxT


@jax.jit
def _lambda_init_pcg(prob: Problem, pattern, params: dict, tau):
    from openslam_g2o_tpu.core.sparse import assemble_ell
    work = prob.with_params(params)
    lin = linearize(work)
    values, _ = assemble_ell(work, pattern, lin)
    diag_blocks = pattern.diag_blocks(work, values)
    m = jnp.zeros((), prob.dtype)
    for g in prob.static.vgroups:
        d = jnp.abs(jnp.diagonal(diag_blocks[g.name], axis1=1, axis2=2))
        m = jnp.maximum(m, jnp.max(d * prob.free[g.name][:, None]))
    return tau * m


class LevenbergMarquardtPCG:
    """LM + block-ELL matrix-free block-Jacobi PCG — the
    `lm_var_pcg`. The ELL pattern is computed host-side once per graph
    topology (the analogue of buildStructure's symbolic phase,
    block_solver.hpp:143-295)."""

    name = "lm_pcg"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5,
                 pcg_iters: int = 150, pcg_tol: float = 1e-8,
                 pcg_cheby: int = 0):
        """pcg_tol is the inexact-Newton forcing tolerance (relative
        residual); LM's gain-ratio test guards step quality, so loose
        tolerances (1e-2) are safe and much cheaper on large graphs —
        mirrors LinearSolverPCG's tolerance property
        (linear_solver_pcg.h:62-75). pcg_cheby > 1 enables the Chebyshev
        polynomial preconditioner; pcg_iters still counts matvecs (the
        outer budget scales down internally). NOTE: Chebyshev trades MORE
        total matvecs for fewer outer iterations, so it only wins in
        latency-dominated regimes (tiny graphs, where the ~30-op
        per-iteration overhead dwarfs the matvec); plain Jacobi-scaled CG
        is the right default once the matvec itself is the cost (measured
        on Manhattan3500 — see CLAUDE.md)."""
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau
        self.pcg_iters = pcg_iters
        self.pcg_tol = pcg_tol
        self.pcg_cheby = pcg_cheby
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem):
        if self._pattern_for is not prob.static:
            from openslam_g2o_tpu.core.sparse import build_ell_pattern
            self._pattern = build_ell_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    def use_pattern(self, prob: Problem, pattern):
        """Install an externally-built ELL pattern (e.g. the incremental
        engine's padding-masked one, sparse.build_ell_pattern(edge_valid=))
        for this problem's static shape."""
        self._pattern = pattern
        self._pattern_for = prob.static

    def init(self, prob: Problem):
        pattern = self.pattern(prob)
        if self.initial_lambda > 0:
            lam = jnp.asarray(self.initial_lambda, prob.dtype)
        else:
            lam = _lambda_init_pcg(prob, pattern, prob.params,
                                   jnp.asarray(self.tau, prob.dtype))
        return {"params": prob.params, "lam": lam,
                "ni": jnp.asarray(2.0, prob.dtype),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted, _ = _lm_pcg_step(
            prob, self.pattern(prob), state["params"], state["lam"],
            state["ni"], state["chi2"], max_trials=self.max_trials,
            pcg_iters=self.pcg_iters, pcg_tol=self.pcg_tol,
            pcg_cheby=self.pcg_cheby)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info


@partial(jax.jit,
         static_argnames=("n_iters", "max_trials", "pcg_iters", "pcg_tol",
                          "warm", "pcg_cheby", "trial_per_iter"))
def lm_pcg_optimize_fused(prob: Problem, pattern, params: dict, lam, ni,
                          chi, n_iters: int = 10, max_trials: int = 10,
                          pcg_iters: int = 75, pcg_tol: float = 1e-8,
                          warm: bool = False, pcg_cheby: int = 0,
                          trial_per_iter: bool = False):
    """Run n_iters LM-PCG iterations as ONE device program (lax.scan) — no
    host round-trip between iterations. The production serving shape: the
    whole optimization is a single XLA executable.

    trial_per_iter=True runs ONE LM trial per scan iteration
    with no inner while_loop: a rejected trial leaves params unchanged,
    doubles lambda, and the next iteration re-linearizes the IDENTICAL
    system — the reference trial loop's exact trajectory
    (optimization_algorithm_levenberg.cpp:95-142), unrolled across scan
    steps (n_iters then counts TRIALS), with no live while_loop in the
    body (see ba_ell_optimize_fused). trial_per_iter=False
    scans the full while-loop step (exact outer-iteration accounting).

    warm=True threads each accepted step's dx into the next step's PCG as a
    warm start — slower per iteration but converges much deeper per step
    near the basin (the polish-phase configuration). Returns
    (params, lam, ni, chi, chi_trajectory [n_iters]).

    chi=None computes the initial chi2 INSIDE the fused program — the
    online engine's per-solve configuration: one dispatch per solve."""
    from openslam_g2o_tpu.core.problem import apply_update_parts
    from openslam_g2o_tpu.core.solvers import _tree_dot

    if chi is None:
        chi = robust_chi2(prob.with_params(params))
    zerosT = {g.name: jnp.zeros((g.tangent_dim, g.count), prob.dtype)
              for g in prob.static.vgroups}

    if trial_per_iter:
        def body(carry, _):
            params, lam, ni, chi, dxT = carry
            work = prob.with_params(params)
            pre = _pcg_precomp(work, pattern)
            dxT_new, ok = _pcg_trial(work, pattern, pre, lam,
                                     dxT if warm else None, pcg_iters,
                                     pcg_tol, pcg_cheby)
            dx = {k: v.T for k, v in dxT_new.items()}
            cand = apply_update_parts(work, dx)
            chi_new = robust_chi2(work, cand)
            solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
            chi_new = jnp.where(solved, chi_new, jnp.inf)
            scale = _tree_dot(dxT_new, jax.tree_util.tree_map(
                lambda d, bi: lam * d + bi, dxT_new, pre["bT"])) + 1e-3
            rho = jnp.where(solved, (chi - chi_new) / scale, -1.0)
            accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            good = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
            lam = jnp.where(accept, lam * good, lam * ni)
            ni = jnp.where(accept, 2.0, ni * 2.0)
            params = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old), cand, params)
            dxT_keep = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old), dxT_new, dxT)
            chi = jnp.where(accept, chi_new, chi)
            return (params, lam, ni, chi, dxT_keep), chi
    else:
        def body(carry, _):
            params, lam, ni, chi, dxT = carry
            (params, lam, ni, chi, trials, ok,
             dxT_new) = _lm_pcg_step.__wrapped__(
                prob, pattern, params, lam, ni, chi,
                dx0T=dxT if warm else None, max_trials=max_trials,
                pcg_iters=pcg_iters, pcg_tol=pcg_tol, pcg_cheby=pcg_cheby)
            return (params, lam, ni, chi, dxT_new), chi

    (params, lam, ni, chi, _), traj = jax.lax.scan(
        body, (params, lam, ni, chi, zerosT), None, length=n_iters)
    return params, lam, ni, chi, traj


# ---------------------------------------------------------------------------
# Dogleg
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_trials",))
def _dogleg_step(prob: Problem, params: dict, delta, lam, was_pd, chi_cur,
                 max_trials: int = 100):
    """One Dogleg outer iteration (optimization_algorithm_dogleg.cpp:57-205):
    blend the steepest-descent step h_sd = alpha*b with the Gauss-Newton step
    inside trust radius delta; accept on rho > 0; grow/shrink delta on
    rho > .75 / < .25. Non-PD Hessians trigger the reference's escalating
    lambda damping (minLambda=1e-12, maxLambda=1e3, factor 10)."""
    work = prob.with_params(params)
    H, b, _ = build_dense_system(work)
    free_t, _ = tangent_masks(work)
    eye_free = jnp.diag(free_t)

    hb = H @ b
    alpha = jnp.dot(b, b) / jnp.maximum(jnp.dot(hb, b), 1e-30)
    h_sd = alpha * b
    hsd_norm = jnp.linalg.norm(h_sd)
    hsd_sq = hsd_norm * hsd_norm

    # -- GN solve with escalating damping when the Hessian went non-PD before
    def damp_cond(st):
        ok, lam_c, x, tries = st
        return jnp.logical_and(jnp.logical_not(ok), tries < 20)

    def damp_body(st):
        ok, lam_c, x, tries = st
        # once the peeled first attempt has failed, escalate lam_c
        # regardless of was_pd: with use_lam pinned to 0 while was_pd, a
        # first-ever non-PD Hessian would repeat the identical undamped
        # factorization 20 times and return a zero GN step, permanently
        # collapsing the trust radius (round-5 review; mirrors the
        # _dogleg_pcg_step fix — reference semantics flip wasPD on the
        # retry too, optimization_algorithm_dogleg.cpp:135-160)
        x_new, solver_ok = solve_dense_cholesky(H + lam_c * eye_free, b)
        lam_next = jnp.where(solver_ok,
                             jnp.maximum(1e-12, lam_c / 5.0),
                             jnp.minimum(lam_c * 10.0, 1e3))
        return solver_ok, lam_next, x_new, tries + 1

    x0, ok0 = solve_dense_cholesky(H + jnp.where(was_pd, 0.0, lam) * eye_free, b)
    lam1 = jnp.where(ok0, jnp.maximum(1e-12, lam / 5.0), lam * 10.0)
    gn_ok, lam_out, h_gn, _ = jax.lax.while_loop(
        damp_cond, damp_body, (ok0, lam1, x0, jnp.int32(0)))
    still_pd = jnp.logical_and(was_pd, ok0)
    hgn_norm = jnp.linalg.norm(h_gn)

    def trial_cond(st):
        tries, good, delta_c, best_params, best_chi, rho = st
        return jnp.logical_and(jnp.logical_not(good), tries < max_trials)

    def trial_body(st):
        tries, good, delta_c, best_params, best_chi, _ = st
        # blend step selection
        bma = h_gn - h_sd
        bma_sq = jnp.maximum(jnp.dot(bma, bma), 1e-30)
        c = jnp.dot(h_sd, bma)
        disc = jnp.sqrt(jnp.maximum(c * c + bma_sq * (delta_c * delta_c - hsd_sq), 0.0))
        beta = jnp.where(c <= 0, (-c + disc) / bma_sq,
                         (delta_c * delta_c - hsd_sq) / jnp.maximum(c + disc, 1e-30))
        h_dl = jnp.where(hgn_norm < delta_c, h_gn,
                         jnp.where(hsd_norm > delta_c,
                                   (delta_c / jnp.maximum(hsd_norm, 1e-30)) * h_sd,
                                   h_sd + beta * bma))
        linear_gain = -jnp.dot(H @ h_dl, h_dl) + 2.0 * jnp.dot(b, h_dl)
        linear_gain = jnp.where(jnp.abs(linear_gain) < 1e-12, 1e-12, linear_gain)
        cand = apply_update(work, h_dl)
        chi_new = robust_chi2(work, cand)
        # non-finite chi2 (divergent retraction): treat as reject AND
        # shrink delta — a NaN rho would leave delta unchanged and burn
        # all max_trials on the identical step (round-5 review)
        finite = jnp.isfinite(chi_new)
        chi_new = jnp.where(finite, chi_new, jnp.inf)
        rho = jnp.where(finite, (chi_cur - chi_new) / linear_gain, -1.0)
        accept = rho > 0
        best_params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), cand, best_params)
        best_chi = jnp.where(accept, chi_new, best_chi)
        hdl_norm = jnp.linalg.norm(h_dl)
        delta_c = jnp.where(rho > 0.75, jnp.maximum(delta_c, 3.0 * hdl_norm),
                            jnp.where(rho < 0.25, delta_c * 0.5, delta_c))
        return tries + 1, accept, delta_c, best_params, best_chi, rho

    init = (jnp.int32(0), jnp.array(False), delta, params, chi_cur,
            jnp.array(-1.0, prob.dtype))
    tries, good, delta_out, best_params, best_chi, _ = jax.lax.while_loop(
        trial_cond, trial_body, init)
    return best_params, delta_out, lam_out, still_pd, best_chi, tries, good


@partial(jax.jit, static_argnames=("max_trials", "pcg_iters", "pcg_tol"))
def _dogleg_pcg_step(prob: Problem, pattern, params: dict, delta, lam,
                     was_pd, chi_cur, max_trials: int = 100,
                     pcg_iters: int = 150, pcg_tol: float = 1e-8):
    """Matrix-free Dogleg on the block-ELL pattern: the analogue of the
    reference's dl_var running over BlockSolverBase::multiplyHessian
    (block_solver.h:90) — H never materializes; h_sd comes from one ELL
    matvec, h_gn from the Jacobi-scaled PCG of the LM-PCG path, and the
    blend/trust-radius semantics are identical to the dense `_dogleg_step`
    (optimization_algorithm_dogleg.cpp:57-205). This lifts Dogleg past the
    dense-Cholesky size ceiling onto exactly the graphs where trust-region
    robustness matters.

    Reference-parity notes: the escalating-lambda retry on a non-PD system
    mirrors the dense step (minLambda=1e-12, maxLambda=1e3, factor 10);
    "solver failed" here means the scaled PCG hit non-finite values or
    negative curvature (pcg_solve's ok flag) instead of a failed Cholesky.
    """
    from openslam_g2o_tpu.core.problem import apply_update_parts
    from openslam_g2o_tpu.core.sparse import (
        ell_matvec_lane_kmajor_hot, hot_add_diag, hot_split)
    from openslam_g2o_tpu.core.solvers import _tree_dot

    work = prob.with_params(params)
    # the per-linearization products and the damped Jacobi-scaled-PCG
    # solve are the SHARED _lm_pcg_step pipeline (round-5 dedup: the
    # previous inline copy had to track every trial-pipeline change)
    pre = _pcg_precomp(work, pattern)
    hot, bT = pre["hot"], pre["bT"]

    # undamped H apply with unit diagonal on fixed slots (the
    # build_dense_system convention — J columns at fixed slots are already
    # masked, so b and every step stay zero there)
    extra0 = {g.name: 1.0 - work.free[g.name] for g in work.static.vgroups}
    vals0 = hot_add_diag(work, pattern, hot, extra0,
                         self_maskT=pre["self_maskT"])
    split0 = hot_split(work, pattern, vals0)
    mv0 = lambda xT: ell_matvec_lane_kmajor_hot(work, pattern, split0, xT)

    hbT = mv0(bT)
    b_dot_b = _tree_dot(bT, bT)
    alpha = b_dot_b / jnp.maximum(_tree_dot(hbT, bT), 1e-30)
    h_sdT = jax.tree_util.tree_map(lambda x: alpha * x, bT)
    hsd_sq = alpha * alpha * b_dot_b
    hsd_norm = jnp.sqrt(hsd_sq)

    def gn_solve(lam_c):
        """Jacobi-scaled PCG solve of (H + lam_c I_free) h = b — the
        _lm_pcg_step per-trial pipeline, without the LM trial semantics."""
        return _pcg_trial(work, pattern, pre, lam_c, None, pcg_iters,
                          pcg_tol, 0)

    def damp_cond(st):
        ok, lam_c, x, tries = st
        return jnp.logical_and(jnp.logical_not(ok), tries < 20)

    def damp_body(st):
        ok, lam_c, x, tries = st
        # once an in-step solve has failed (we only get here after the
        # peeled first attempt failed), escalate lam_c regardless of
        # was_pd: repeating the identical lam=0 PCG solve 20 times would
        # burn pcg_iters matvecs per retry for the same failure
        # (round-4 advisor finding; the dense _dogleg_step adopted the
        # same retry rule in round 5)
        x_new, solver_ok = gn_solve(lam_c)
        lam_next = jnp.where(solver_ok,
                             jnp.maximum(1e-12, lam_c / 5.0),
                             jnp.minimum(lam_c * 10.0, 1e3))
        return solver_ok, lam_next, x_new, tries + 1

    x0, ok0 = gn_solve(jnp.where(was_pd, 0.0, lam))
    lam1 = jnp.where(ok0, jnp.maximum(1e-12, lam / 5.0), lam * 10.0)
    gn_ok, lam_out, h_gnT, _ = jax.lax.while_loop(
        damp_cond, damp_body, (ok0, lam1, x0, jnp.int32(0)))
    still_pd = jnp.logical_and(was_pd, ok0)
    hgn_norm = jnp.sqrt(_tree_dot(h_gnT, h_gnT))

    def trial_cond(st):
        tries, good = st[0], st[1]
        return jnp.logical_and(jnp.logical_not(good), tries < max_trials)

    def trial_body(st):
        tries, good, delta_c, best_params, best_chi, _ = st
        bmaT = jax.tree_util.tree_map(jnp.subtract, h_gnT, h_sdT)
        bma_sq = jnp.maximum(_tree_dot(bmaT, bmaT), 1e-30)
        c = _tree_dot(h_sdT, bmaT)
        disc = jnp.sqrt(jnp.maximum(
            c * c + bma_sq * (delta_c * delta_c - hsd_sq), 0.0))
        beta = jnp.where(c <= 0, (-c + disc) / bma_sq,
                         (delta_c * delta_c - hsd_sq)
                         / jnp.maximum(c + disc, 1e-30))
        sd_scale = delta_c / jnp.maximum(hsd_norm, 1e-30)
        h_dlT = jax.tree_util.tree_map(
            lambda g, s, m: jnp.where(
                hgn_norm < delta_c, g,
                jnp.where(hsd_norm > delta_c, sd_scale * s, s + beta * m)),
            h_gnT, h_sdT, bmaT)
        linear_gain = -_tree_dot(mv0(h_dlT), h_dlT) \
            + 2.0 * _tree_dot(bT, h_dlT)
        linear_gain = jnp.where(jnp.abs(linear_gain) < 1e-12, 1e-12,
                                linear_gain)
        cand = apply_update_parts(work, {k: v.T for k, v in h_dlT.items()})
        chi_new = robust_chi2(work, cand)
        # non-finite chi2: reject AND shrink delta (see _dogleg_step)
        finite = jnp.isfinite(chi_new)
        chi_new = jnp.where(finite, chi_new, jnp.inf)
        rho = jnp.where(finite, (chi_cur - chi_new) / linear_gain, -1.0)
        accept = rho > 0
        best_params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), cand, best_params)
        best_chi = jnp.where(accept, chi_new, best_chi)
        hdl_norm = jnp.sqrt(_tree_dot(h_dlT, h_dlT))
        delta_c = jnp.where(rho > 0.75,
                            jnp.maximum(delta_c, 3.0 * hdl_norm),
                            jnp.where(rho < 0.25, delta_c * 0.5, delta_c))
        return tries + 1, accept, delta_c, best_params, best_chi, rho

    init = (jnp.int32(0), jnp.array(False), delta, params, chi_cur,
            jnp.array(-1.0, prob.dtype))
    tries, good, delta_out, best_params, best_chi, _ = jax.lax.while_loop(
        trial_cond, trial_body, init)
    return best_params, delta_out, lam_out, still_pd, best_chi, tries, good


class Dogleg:
    """Dogleg trust-region algorithm (defaults match
    optimization_algorithm_dogleg.cpp:44-47)."""

    name = "dl"

    def __init__(self, initial_delta: float = 1e4, initial_lambda: float = 1e-7,
                 max_trials_after_failure: int = 100):
        self.initial_delta = initial_delta
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure

    def init(self, prob: Problem):
        return {
            "params": prob.params,
            "delta": jnp.asarray(self.initial_delta, prob.dtype),
            "lam": jnp.asarray(self.initial_lambda, prob.dtype),
            "was_pd": jnp.array(True),
            "chi2": robust_chi2(prob),
        }

    def step(self, prob: Problem, state: dict):
        params, delta, lam, was_pd, chi, tries, good = _dogleg_step(
            prob, state["params"], state["delta"], state["lam"],
            state["was_pd"], state["chi2"], max_trials=self.max_trials)
        new_state = {"params": params, "delta": delta, "lam": lam,
                     "was_pd": was_pd, "chi2": chi}
        info = {"chi2": float(chi), "delta": float(delta),
                "tries": int(tries), "ok": bool(good)}
        return new_state, info


class DoglegPCG:
    """Dogleg + block-ELL matrix-free PCG — `dl_var_pcg`: trust-region
    robustness at matrix-free scale (the dense Dogleg caps at the
    Cholesky size ceiling; this one runs wherever lm_var_pcg runs)."""

    name = "dl_pcg"

    def __init__(self, initial_delta: float = 1e4,
                 initial_lambda: float = 1e-7,
                 max_trials_after_failure: int = 100,
                 pcg_iters: int = 150, pcg_tol: float = 1e-8):
        self.initial_delta = initial_delta
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.pcg_iters = pcg_iters
        self.pcg_tol = pcg_tol
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem):
        if self._pattern_for is not prob.static:
            from openslam_g2o_tpu.core.sparse import build_ell_pattern
            self._pattern = build_ell_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    use_pattern = LevenbergMarquardtPCG.use_pattern

    def init(self, prob: Problem):
        self.pattern(prob)
        return {
            "params": prob.params,
            "delta": jnp.asarray(self.initial_delta, prob.dtype),
            "lam": jnp.asarray(self.initial_lambda, prob.dtype),
            "was_pd": jnp.array(True),
            "chi2": robust_chi2(prob),
        }

    def step(self, prob: Problem, state: dict):
        params, delta, lam, was_pd, chi, tries, good = _dogleg_pcg_step(
            prob, self.pattern(prob), state["params"], state["delta"],
            state["lam"], state["was_pd"], state["chi2"],
            max_trials=self.max_trials, pcg_iters=self.pcg_iters,
            pcg_tol=self.pcg_tol)
        new_state = {"params": params, "delta": delta, "lam": lam,
                     "was_pd": was_pd, "chi2": chi}
        info = {"chi2": float(chi), "delta": float(delta),
                "tries": int(tries), "ok": bool(good)}
        return new_state, info


# ---------------------------------------------------------------------------
# Outer driver
# ---------------------------------------------------------------------------

@dataclass
class TerminateCriterion:
    """SparseOptimizerTerminateAction analogue
    (g2o/core/sparse_optimizer_terminate_action.cpp:21-45): stop when the
    relative chi2 gain drops below `gain_threshold`."""
    gain_threshold: float = 1e-6
    max_iterations: int = 0  # 0: use the optimize() budget only

    def should_stop(self, prev_chi, chi, iteration):
        if self.max_iterations and iteration >= self.max_iterations:
            return True
        if prev_chi is None:
            return False
        if chi == 0:
            return True
        gain = (prev_chi - chi) / chi
        return 0 <= gain < self.gain_threshold


def optimize(prob: Problem, algorithm=None, iterations: int = 10,
             verbose: bool = False, terminate: Optional[TerminateCriterion] = None,
             pre_iteration=None, post_iteration=None):
    """Run the outer iteration loop; the analogue of
    SparseOptimizer::optimize (sparse_optimizer.cpp:354-419).

    pre_iteration/post_iteration: optional callbacks (iteration, state) — the
    HyperGraphAction hook points (hyper_graph_action.h:49-205); a
    post_iteration callback returning True requests a stop (how
    SparseOptimizerTerminateAction signals the force-stop flag).

    Returns (optimized Problem, stats list — one dict per iteration, matching
    the reference's G2OBatchStatistics fields we can populate host-side).
    """
    algorithm = algorithm or LevenbergMarquardt()
    state = algorithm.init(prob)
    stats = []
    prev_chi = None
    cum_time = 0.0
    for it in range(iterations):
        if pre_iteration is not None:
            pre_iteration(it, state)
        t0 = time.monotonic()
        state, info = algorithm.step(prob, state)
        jax.block_until_ready(state["params"])
        dt = time.monotonic() - t0
        cum_time += dt
        info.update({"iteration": it, "time": dt, "cum_time": cum_time})
        stats.append(info)
        if post_iteration is not None and post_iteration(it, state):
            break
        if verbose:
            extras = ""
            if "lambda" in info:
                extras = f"\t lambda= {info['lambda']:.6g}\t levenbergIter= {info['levenberg_iters']}"
            print(f"iteration= {it}\t chi2= {info['chi2']:.6f}\t time= {dt:.5f}\t "
                  f"cumTime= {cum_time:.5f}{extras}")
        if terminate is not None and terminate.should_stop(prev_chi, info["chi2"], it):
            break
        prev_chi = info["chi2"]
    return prob.with_params(state["params"]), stats
