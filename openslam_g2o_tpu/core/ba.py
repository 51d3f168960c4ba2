"""Schur-complement bundle adjustment: landmark marginalization.

JAX re-design of the reference's BlockSolver Schur path
(g2o/core/block_solver.hpp:143-295 buildStructure, :353-486 solve): the
reference materializes Hschur = Hpp - Hpl Hll^-1 Hpl^T block-by-block under
OpenMP mutexes and hands it to CHOLMOD. Here the landmark system is never
materialized globally:

* Hpp (pose-pose) is assembled dense over the pose tangent block — a
  [Tp, Tp] dense matrix is cheap on an accelerator for Tp up to ~2e4,
* Hll is a batched ``[L, d, d]`` block-diagonal (landmarks are conditionally
  independent — the same assumption the reference's Schur layout makes),
  inverted with one batched solve,
* Hpl lives as per-edge blocks W_e; the reduced system S = Hpp - W Hll^-1 W^T
  is applied **matrix-free** inside block-Jacobi PCG: two segment_sums and
  two gathers per matvec, O(E) work, no landmark-pair enumeration — the
  collective-friendly formulation of block_solver.hpp:381-432's mutex loop,
* back-substitution dx_l = Hll^-1 (b_l - W^T dx_p) is one more segment_sum.

Requires: at most ONE marginalized vertex group, and every edge touches at
most one marginalized vertex (the reference's landmark assumption).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from openslam_g2o_tpu.core import registry
from openslam_g2o_tpu.core.problem import (
    Problem, apply_update, linearize, robust_chi2, _slot_tangent_indices,
)
from openslam_g2o_tpu.core.solvers import batched_small_inv, pcg_solve

__all__ = ["schur_build", "schur_solve", "build_schur_pattern",
           "LevenbergMarquardtSchur"]


def _landmark_group(problem: Problem):
    mg = problem.static.marginalized_groups
    if len(mg) != 1:
        raise ValueError(
            f"Schur solver expects exactly one marginalized group, got "
            f"{[g.name for g in mg]}")
    return mg[0]


def build_schur_pattern(problem: Problem) -> dict:
    """Host-side symbolic phase: the by-landmark and by-camera sort
    permutations for every (edge group, landmark slot, pose slot) pair.
    These depend only on topology (the analogue of buildStructure's
    symbolic work, block_solver.hpp:143-295) — computing them once in numpy
    keeps device sorts out of the compiled step."""
    import numpy as np
    lg = _landmark_group(problem)
    out = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        slot_groups = [problem.static.vgroup(g) for g in eg.slots]
        lm_slots = [s for s in range(len(slot_groups))
                    if slot_groups[s].name == lg.name]
        pose_slots = [s for s in range(len(slot_groups)) if s not in lm_slots]
        for s in lm_slots:
            li = np.asarray(ea.indices[s])
            perm_lm = np.argsort(li, kind="stable").astype(np.int32)
            for t in pose_slots:
                ci = np.asarray(ea.indices[t])
                perm_cam = np.argsort(ci, kind="stable").astype(np.int32)
                out[(eg.key, s, t)] = {
                    "perm_lm": jnp.asarray(perm_lm),
                    "li_sorted": jnp.asarray(li[perm_lm].astype(np.int32)),
                    "perm_cam": jnp.asarray(perm_cam),
                    "cam_sorted": jnp.asarray(ci[perm_cam].astype(np.int32)),
                }
    return out


def schur_build(problem: Problem, params: Optional[dict] = None,
                lin: Optional[dict] = None, pattern: Optional[dict] = None):
    """Assemble {Hpp, b_p, Hll, b_l, per-edge W blocks}.

    Pose tangent dims: [0, Tp); landmark group occupies [Tp, T).
    Fixed vertices are already masked out of the Jacobians by linearize().
    """
    lg = _landmark_group(problem)
    Tp = problem.static.pose_dim
    dt = problem.dtype
    dl = lg.tangent_dim
    L = lg.count
    if lin is None:
        lin = linearize(problem, params)

    Hpp = jnp.zeros((Tp, Tp), dtype=dt)
    b_p = jnp.zeros((Tp,), dtype=dt)
    Hll = jnp.zeros((L, dl, dl), dtype=dt)
    b_l = jnp.zeros((L, dl), dtype=dt)
    cross = []  # per edge group with a landmark slot: (W, rows, lidx, pgroup)

    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        resid, jacs, w = lin[eg.key]
        w_omega = w[:, None, None] * ea.information
        k = eg.etype.num_vertices
        slot_groups = [problem.static.vgroup(g) for g in eg.slots]
        lm_slots = [s for s in range(k) if slot_groups[s].name == lg.name]
        if len(lm_slots) > 1:
            raise ValueError(
                f"edge {eg.key} touches {len(lm_slots)} marginalized vertices; "
                f"Schur requires at most one (landmark independence)")
        pose_slots = [s for s in range(k) if s not in lm_slots]

        idx = [_slot_tangent_indices(slot_groups[s], ea.indices[s])
               for s in range(k)]

        for s in pose_slots:
            js_w = jnp.einsum("eas,eab->esb", jacs[s], w_omega)
            b_p = b_p.at[idx[s]].add(-jnp.einsum("esb,eb->es", js_w, resid))
            for t in pose_slots:
                if t < s:
                    continue
                blk = jnp.einsum("esb,ebt->est", js_w, jacs[t])
                Hpp = Hpp.at[idx[s][:, :, None], idx[t][:, None, :]].add(blk)
                if t != s:
                    Hpp = Hpp.at[idx[t][:, :, None], idx[s][:, None, :]].add(
                        jnp.swapaxes(blk, 1, 2))

        for s in lm_slots:
            li = ea.indices[s]

            def _perms_for(t):
                key = (eg.key, s, t)
                if pattern is not None and key in pattern:
                    return pattern[key]
                perm_lm = jnp.argsort(li)
                p_ = {"perm_lm": perm_lm, "li_sorted": li[perm_lm]}
                if t is not None:
                    cam_local = ea.indices[t].astype(jnp.int32)
                    perm_cam = jnp.argsort(cam_local)
                    p_["perm_cam"] = perm_cam
                    p_["cam_sorted"] = cam_local[perm_cam]
                return p_

            lm_perms = _perms_for(pose_slots[0] if pose_slots else None)
            js_w = jnp.einsum("eas,eab->esb", jacs[s], w_omega)
            Hll = Hll + jax.ops.segment_sum(
                jnp.einsum("esb,ebt->est", js_w, jacs[s])[lm_perms["perm_lm"]],
                lm_perms["li_sorted"], num_segments=L, indices_are_sorted=True)
            b_l = b_l + jax.ops.segment_sum(
                -jnp.einsum("esb,eb->es", js_w, resid)[lm_perms["perm_lm"]],
                lm_perms["li_sorted"], num_segments=L, indices_are_sorted=True)
            for t in pose_slots:
                p_ = _perms_for(t)
                W = jnp.einsum("eas,eab,ebt->est", jacs[t], w_omega, jacs[s])
                # W: [E, Dp, dl]; the two sorted orderings make every
                # accumulation in the PCG hot loop a sorted segment_sum
                # (gathers + contiguous reductions — no random scatters)
                cross.append({
                    "W": W, "rows": idx[t], "li": li, "group": slot_groups[t],
                    "perm_cam": p_["perm_cam"], "cam_sorted": p_["cam_sorted"],
                    "perm_lm": p_["perm_lm"], "li_sorted": p_["li_sorted"],
                })

    return {"Hpp": Hpp, "b_p": b_p, "Hll": Hll, "b_l": b_l, "cross": cross,
            "L": L, "dl": dl, "Tp": Tp}


def _accumulate_lm(entry, contrib, L):
    """sum_e contrib_e into landmark bins (sorted segment_sum)."""
    return jax.ops.segment_sum(contrib[entry["perm_lm"]], entry["li_sorted"],
                               num_segments=L, indices_are_sorted=True)


def _accumulate_pose(entry, contrib, y):
    """sum_e contrib_e [E, Dp] into the pose vector y (sorted segment_sum
    per camera, then one contiguous slice add)."""
    g = entry["group"]
    y_cam = jax.ops.segment_sum(contrib[entry["perm_cam"]],
                                entry["cam_sorted"], num_segments=g.count,
                                indices_are_sorted=True)
    seg = jax.lax.dynamic_slice(y, (g.offset,), (g.count * g.tangent_dim,))
    seg = seg + y_cam.reshape(-1)
    return jax.lax.dynamic_update_slice(y, seg, (g.offset,))


def _pose_masks(problem: Problem):
    """free/fixed masks restricted to the pose tangent block."""
    parts = []
    for g in problem.static.vgroups:
        if g.offset < problem.static.pose_dim:
            parts.append(jnp.repeat(problem.free[g.name], g.tangent_dim))
    free_p = jnp.concatenate(parts)
    return free_p, 1.0 - free_p


def schur_solve(problem: Problem, sys, lam, pcg_iters: int = 250,
                pcg_tol: float = 1e-8):
    """Solve the damped system via the reduced pose system + back-substitution.

    Returns (dx_full [T], ok). Damping adds lam to every free diagonal entry
    (the reference's setLambda, block_solver.hpp:564-589).
    """
    lg = _landmark_group(problem)
    Hpp, b_p, Hll, b_l = sys["Hpp"], sys["b_p"], sys["Hll"], sys["b_l"]
    cross = sys["cross"]
    L, dl, Tp = sys["L"], sys["dl"], sys["Tp"]
    dt = problem.dtype

    free_p, fixed_p = _pose_masks(problem)
    free_l = problem.free[lg.name]
    eye = jnp.eye(dl, dtype=dt)

    # damped landmark blocks; fixed landmarks get identity (their b is 0)
    Hll_d = Hll + (lam * free_l + (1.0 - free_l))[:, None, None] * eye
    Hinv = batched_small_inv(Hll_d)

    Hpp_d = Hpp + jnp.diag(lam * free_p + fixed_p)

    # reduced rhs: b_p - sum_e W_e (Hinv b_l)_{l(e)}
    hib = jnp.einsum("lst,lt->ls", Hinv, b_l)            # [L, dl]
    b_red = b_p
    for entry in cross:
        contrib = -jnp.einsum("est,et->es", entry["W"], hib[entry["li"]])
        b_red = _accumulate_pose(entry, contrib, b_red)

    def s_matvec(x):
        """S x = Hpp_d x - W Hinv W^T x — gathers + sorted segment sums."""
        y = Hpp_d @ x
        u = jnp.zeros((L, dl), dtype=dt)
        for entry in cross:
            u = u + _accumulate_lm(
                entry, jnp.einsum("est,es->et", entry["W"], x[entry["rows"]]),
                L)
        v = jnp.einsum("lst,lt->ls", Hinv, u)
        for entry in cross:
            contrib = -jnp.einsum("est,et->es", entry["W"], v[entry["li"]])
            y = _accumulate_pose(entry, contrib, y)
        return y

    # block-Jacobi preconditioner on the pose groups: diagonal blocks of S
    # (exact when each (pose, landmark) pair appears in one edge — true for
    # BA observations)
    precond_blocks = []
    pose_groups = [g for g in problem.static.vgroups
                   if g.offset < problem.static.pose_dim]
    for g in pose_groups:
        D = g.tangent_dim
        gidx = (g.offset + jnp.arange(g.count, dtype=jnp.int32)[:, None] * D
                + jnp.arange(D, dtype=jnp.int32)[None, :])
        blocks = Hpp_d[gidx[:, :, None], gidx[:, None, :]]      # [N, D, D]
        for entry in cross:
            if entry["group"].name != g.name or entry["W"].shape[1] != D:
                continue
            corr = -jnp.einsum("est,etu,evu->esv", entry["W"],
                               Hinv[entry["li"]], entry["W"])
            blocks = blocks + jax.ops.segment_sum(
                corr[entry["perm_cam"]], entry["cam_sorted"],
                num_segments=g.count, indices_are_sorted=True)
        precond_blocks.append((g, gidx, batched_small_inv(blocks)))

    def precond(r):
        out = jnp.zeros_like(r)
        for g, gidx, binv in precond_blocks:
            rg = r[gidx]                                       # [N, D]
            out = out.at[gidx].set(jnp.einsum("nst,nt->ns", binv, rg))
        return out

    # PCG on the reduced system
    dx_p, ok = pcg_solve(s_matvec, b_red, precond=precond,
                         max_iter=pcg_iters, tol=pcg_tol)
    dx_p = dx_p * free_p

    # back-substitute landmarks: dx_l = Hinv (b_l - W^T dx_p)
    u = jnp.zeros((L, dl), dtype=dt)
    for entry in cross:
        u = u + _accumulate_lm(
            entry, jnp.einsum("est,es->et", entry["W"], dx_p[entry["rows"]]), L)
    dx_l = jnp.einsum("lst,lt->ls", Hinv, b_l - u) * free_l[:, None]

    dx = jnp.concatenate([dx_p, dx_l.reshape(-1)])
    b_full = jnp.concatenate([b_p, b_l.reshape(-1)])
    raw_diag = jnp.concatenate([jnp.diagonal(Hpp),
                                jnp.diagonal(Hll, axis1=1, axis2=2).reshape(-1)])
    return dx, ok, b_full, raw_diag


@partial(jax.jit, static_argnames=("max_trials", "pcg_iters"))
def _lm_schur_step(prob: Problem, params: dict, lam, ni, chi_cur,
                   pattern=None, max_trials: int = 10, pcg_iters: int = 250):
    """One LM iteration with Schur-complement landmark elimination.
    Trial-loop semantics identical to _lm_step (LM reference
    optimization_algorithm_levenberg.cpp:95-142). `pattern` carries the
    host-precomputed sort permutations (build_schur_pattern)."""
    work = prob.with_params(params)
    lin = linearize(work)
    sys = schur_build(work, lin=lin, pattern=pattern)

    def trial_cond(st):
        trials, done, rho = st[0], st[1], st[2]
        return jnp.logical_and(jnp.logical_not(done),
                               jnp.logical_and(rho < 0, trials < max_trials))

    def trial_body(st):
        trials, done, rho, lam, ni, best_params, best_chi = st
        dx, ok, b_full, _ = schur_solve(work, sys, lam, pcg_iters=pcg_iters)
        cand = apply_update(work, dx)
        chi_new = robust_chi2(work, cand)
        chi_new = jnp.where(ok, chi_new, jnp.inf)
        scale = jnp.dot(dx, lam * dx + b_full) + 1e-3
        rho = (chi_cur - chi_new) / scale
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
    return best_params, lam, ni, best_chi, trials, accepted


@jax.jit
def _schur_lambda_init(prob: Problem, params: dict, tau, pattern=None):
    work = prob.with_params(params)
    sys = schur_build(work, pattern=pattern)
    raw = jnp.concatenate([jnp.diagonal(sys["Hpp"]),
                           jnp.diagonal(sys["Hll"], axis1=1, axis2=2).reshape(-1)])
    return tau * jnp.max(jnp.abs(raw))


class LevenbergMarquardtSchur:
    """LM with Schur landmark marginalization — the `lm_fix6_3`-style
    configuration of the reference (requiresMarginalize algorithms,
    solver_csparse.cpp:104-124)."""

    name = "lm_schur"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5,
                 pcg_iters: int = 250):
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau
        self.pcg_iters = pcg_iters
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem):
        if self._pattern_for is not prob.static:
            self._pattern = build_schur_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    def init(self, prob: Problem):
        if self.initial_lambda > 0:
            lam = jnp.asarray(self.initial_lambda, prob.dtype)
        else:
            lam = _schur_lambda_init(prob, prob.params,
                                     jnp.asarray(self.tau, prob.dtype),
                                     pattern=self.pattern(prob))
        return {"params": prob.params, "lam": lam,
                "ni": jnp.asarray(2.0, prob.dtype),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted = _lm_schur_step(
            prob, state["params"], state["lam"], state["ni"], state["chi2"],
            pattern=self.pattern(prob),
            max_trials=self.max_trials, pcg_iters=self.pcg_iters)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info
