"""Per-phase performance statistics.

The analogue of G2OBatchStatistics (g2o/core/batch_stats.h:40-84): chi2 plus
wall-clock per optimization phase. The reference threads timers through the
solver via a global pointer; in a jit-compiled world the production step is
one fused program (phases are not separable without de-fusing), so this
module provides an explicit *profiling mode* that runs each phase as its own
jitted program with device synchronization between — same numbers, honest
timings, used by the CLI's -stats and by perf work.
"""
from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp

from openslam_g2o_tpu.core import problem as P

__all__ = ["profile_iteration"]


def _timed(fn, *args, repeats=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.monotonic()
    for _ in range(repeats):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.monotonic() - t0) / repeats


def profile_iteration(problem: P.Problem, solver: str = "dense",
                      lam: float = 1e-5, pcg_iters: int = 100,
                      repeats: int = 3) -> dict:
    """Time one LM-style iteration phase by phase (compile excluded).

    Returns a dict with the G2OBatchStatistics-style fields:
    time_residuals, time_linearize (both inside time_quadratic_form for the
    fused linearize), time_quadratic_form, time_schur_complement,
    time_linear_solution, time_update, chi2, hessian_dims, and the iteration
    total.

    HONEST ACCOUNTING: every de-fused phase here is its own device program,
    so each raw time carries the per-program dispatch floor (often LARGER
    than the phase's compute on small graphs). The floor is measured at entry with a trivial program and
    reported as `dispatch_floor`; each phase also gets a floor-subtracted
    `time_*_net`, `iteration_total` sums the NET times, and
    `iteration_fused` times the production one-program LM step for
    cross-checking (the net sum should land within ~20% of it).
    """
    stats: dict = {"solver": solver}
    dt = problem.dtype

    floor_fn = jax.jit(lambda x: x + 1.0)
    _, floor = _timed(floor_fn, jnp.zeros((), dt), repeats=max(repeats, 5))
    stats["dispatch_floor"] = floor

    errors_fn = jax.jit(lambda p: P.compute_errors(problem, p))
    _, stats["time_residuals"] = _timed(errors_fn, problem.params,
                                        repeats=repeats)

    chi_fn = jax.jit(lambda p: P.robust_chi2(problem, p))
    chi, t_chi = _timed(chi_fn, problem.params, repeats=repeats)
    stats["chi2"] = float(chi)
    stats["time_chi2"] = t_chi

    lin_fn = jax.jit(lambda p: P.linearize(problem, p))
    lin, stats["time_linearize"] = _timed(lin_fn, problem.params,
                                          repeats=repeats)

    lam_arr = jnp.asarray(lam, dt)
    if solver == "dense":
        asm_fn = jax.jit(lambda l: P.build_dense_system(problem, lin=l))
        (H, b, _), stats["time_quadratic_form"] = _timed(asm_fn, lin,
                                                         repeats=repeats)
        from openslam_g2o_tpu.core.solvers import solve_dense_cholesky
        free_t, _ = P.tangent_masks(problem)
        solve_fn = jax.jit(
            lambda H, b: solve_dense_cholesky(H + lam_arr * jnp.diag(free_t), b))
        (dx, ok), stats["time_linear_solution"] = _timed(solve_fn, H, b,
                                                         repeats=repeats)
        upd_fn = jax.jit(lambda d: P.apply_update(problem, d))
    elif solver == "pcg":
        from openslam_g2o_tpu.core.sparse import (
            build_ell_pattern, assemble_ell, ell_matvec)
        from openslam_g2o_tpu.core.problem import (
            block_jacobi_preconditioner, apply_update_parts)
        from openslam_g2o_tpu.core.solvers import pcg_solve
        pattern = build_ell_pattern(problem)
        asm_fn = jax.jit(lambda l: assemble_ell(problem, pattern, l))
        (values, b), stats["time_quadratic_form"] = _timed(asm_fn, lin,
                                                           repeats=repeats)

        def solve(values, b):
            diag = pattern.diag_blocks(problem, values)
            free = {g.name: problem.free[g.name][:, None]
                    for g in problem.static.vgroups}
            extra = {k: lam_arr * f + (1.0 - f) for k, f in free.items()}
            mv = lambda x: ell_matvec(problem, pattern, values, x,
                                      extra_diag=extra)
            pre = block_jacobi_preconditioner(problem, diag, lam_arr)
            return pcg_solve(mv, b, precond=pre, max_iter=pcg_iters)

        solve_fn = jax.jit(solve)
        (dx, ok), stats["time_linear_solution"] = _timed(solve_fn, values, b,
                                                         repeats=repeats)
        upd_fn = jax.jit(lambda d: apply_update_parts(problem, d))
    elif solver == "schur":
        from openslam_g2o_tpu.core.ba import (
            build_schur_pattern, schur_build, schur_solve)
        pattern = build_schur_pattern(problem)

        # schur_build's output carries static group records (not jit
        # outputs), so time build-only via its array parts, and the solve as
        # (build+solve) - build
        def asm_arrays(l):
            sys = schur_build(problem, lin=l, pattern=pattern)
            return (sys["Hpp"], sys["b_p"], sys["Hll"], sys["b_l"],
                    tuple(e["W"] for e in sys["cross"]))

        _, t_build = _timed(jax.jit(asm_arrays), lin, repeats=repeats)
        stats["time_schur_complement"] = t_build
        stats["time_quadratic_form"] = t_build

        def build_and_solve(l):
            sys = schur_build(problem, lin=l, pattern=pattern)
            dx, ok, _, _ = schur_solve(problem, sys, lam_arr,
                                       pcg_iters=pcg_iters)
            return dx, ok

        (dx, ok), t_full = _timed(jax.jit(build_and_solve), lin,
                                  repeats=repeats)
        stats["time_linear_solution"] = max(t_full - t_build, 0.0)
        upd_fn = jax.jit(lambda d: P.apply_update(problem, d))
    else:
        raise ValueError(f"unknown solver {solver!r}")

    new_params, stats["time_update"] = _timed(upd_fn, dx, repeats=repeats)
    stats.update(hessian_shape_stats(problem, solver=solver))
    phase_keys = [k for k in stats
                  if k.startswith("time_") and k != "time_chi2"]
    for k in list(phase_keys):
        stats[k + "_net"] = max(stats[k] - stats["dispatch_floor"], 0.0)
    stats["iteration_total"] = sum(stats[k + "_net"] for k in phase_keys)

    # fused cross-check: the production one-program LM step (trial loop
    # forced to a single accepted trial via a huge incoming chi2)
    ni0 = jnp.asarray(2.0, dt)
    big_chi = jnp.asarray(1e30, dt)
    fused_fn = None
    if solver == "dense":
        from openslam_g2o_tpu.core.algorithms import _lm_step
        fused_fn = lambda p: _lm_step(problem, p, lam_arr, ni0, big_chi)[3]
    elif solver == "pcg":
        from openslam_g2o_tpu.core.algorithms import _lm_pcg_step
        fused_fn = lambda p: _lm_pcg_step(
            problem, pattern, p, lam_arr, ni0, big_chi,
            pcg_iters=pcg_iters)[3]
    elif solver == "schur":
        from openslam_g2o_tpu.core.ba import _lm_schur_step
        fused_fn = lambda p: _lm_schur_step(
            problem, p, lam_arr, ni0, big_chi, pcg_iters=pcg_iters)[3]
    if fused_fn is not None:
        _, stats["iteration_fused"] = _timed(fused_fn, problem.params,
                                             repeats=repeats)
        stats["iteration_fused_net"] = max(
            stats["iteration_fused"] - stats["dispatch_floor"], 0.0)
    if fused_fn is not None and solver == "pcg":
        # the de-fused PCG solve necessarily runs a DIFFERENT pipeline than
        # production (plain Jacobi-preconditioned CG on the unscaled system
        # vs the folded-damping Jacobi-SCALED lane-major loop) and converges
        # in more iterations for the same tolerance — reporting it as "the"
        # solve time would overstate the phase by ~2x. Report it as
        # *_defused and attribute the production solve by DIFFERENCING: the
        # fused one-program step minus the independently measured phases.
        stats["time_linear_solution_defused"] = stats.pop(
            "time_linear_solution")
        stats["time_linear_solution_defused_net"] = stats.pop(
            "time_linear_solution_net")
        chi2_net = max(stats["time_chi2"] - stats["dispatch_floor"], 0.0)
        others = sum(stats[k + "_net"] for k in (
            "time_residuals", "time_linearize", "time_quadratic_form",
            "time_update"))
        stats["time_linear_solution_net"] = max(
            stats["iteration_fused_net"] - others - chi2_net, 0.0)
        stats["iteration_total"] = (others + chi2_net
                                    + stats["time_linear_solution_net"])
    return stats


def hessian_shape_stats(problem: P.Problem, solver: str = "dense") -> dict:
    """Structural fields of G2OBatchStatistics (batch_stats.h:58-75):
    Hessian dimensions (total / pose / landmark), scalar and block nnz of the
    stored system, and the factor-fill analogue for the dense path (dense
    Cholesky "nnz" = full lower triangle — the honest dense equivalent of
    choleskyNNZ)."""
    out = {
        "hessian_dims": problem.static.total_dim,
        "hessian_pose_dims": problem.static.pose_dim,
        "hessian_landmark_dims":
            problem.static.total_dim - problem.static.pose_dim,
        "num_vertices": sum(g.count for g in problem.static.vgroups),
        "num_edges": sum(eg.count for eg in problem.static.egroups),
    }
    if solver == "dense":
        T = problem.static.total_dim
        out["hessian_nnz"] = T * T
        out["cholesky_nnz"] = T * (T + 1) // 2
    else:
        # stored block entries of the ELL layout (incl. padding — the memory
        # the SpMV actually streams) and the exact symbolic block nnz
        from openslam_g2o_tpu.core.sparse import build_ell_pattern
        import numpy as np
        pattern = build_ell_pattern(problem)
        stored = 0
        for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
            rg = problem.static.vgroup(rg_name)
            cg = problem.static.vgroup(cg_name)
            stored += rg.count * pattern.K[pid] \
                * rg.tangent_dim * cg.tangent_dim
        # exact symbolic block nnz: unique (row, col) per group pair straight
        # from the edge index tables (what build_ell_pattern deduplicates)
        exact = 0
        pair_cells: dict = {}
        for eg in problem.static.egroups:
            ea = problem.edges[eg.key]
            k = eg.etype.num_vertices
            idx = [np.asarray(ea.indices[s]).astype(np.int64) for s in range(k)]
            for s in range(k):
                for t in range(k):
                    key = (eg.slots[s], eg.slots[t])
                    cg = problem.static.vgroup(eg.slots[t])
                    pair_cells.setdefault(key, []).append(
                        idx[s] * cg.count + idx[t])
            del idx
        for (rn, cn), cells in pair_cells.items():
            rg = problem.static.vgroup(rn)
            cg = problem.static.vgroup(cn)
            n_uniq = len(np.unique(np.concatenate(cells)))
            exact += n_uniq * rg.tangent_dim * cg.tangent_dim
        out["hessian_nnz"] = int(exact)
        out["hessian_nnz_stored_ell"] = int(stored)
    return out
