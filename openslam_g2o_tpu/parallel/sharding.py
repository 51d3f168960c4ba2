"""Multi-chip execution: edge-sharded linearization + collective reduction.

The reference's only intra-process parallelism is optional OpenMP over edges
with per-vertex mutexes (SURVEY §2.7; block_solver.hpp:521-545,
sparse_optimizer.cpp:70-76). The equivalent here is SPMD over a device
mesh: each device owns a shard of every edge table, linearizes its edges with
the same vmapped kernels as the single-chip path, accumulates its *partial*
dense system (H_d, b_d, chi2_d), and a psum over the mesh replaces the
mutex-guarded shared-memory accumulation. Vertex parameter tables are
replicated (they are tiny next to the edge data and the [T, T] system).

The reduced system is then solved identically on every chip (replicated dense
Cholesky — cheaper than sharding the factorization at these sizes), so the
trial loop of LM needs no further communication.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openslam_g2o_tpu.core.problem import (
    EdgeArrays, Problem, apply_update, build_dense_system, linearize,
    robust_chi2, tangent_masks, edge_chi2, compute_errors,
)
from openslam_g2o_tpu.core import robust as robust_mod
from openslam_g2o_tpu.core.solvers import solve_dense_cholesky

__all__ = ["pad_problem_edges", "make_sharded_lm_step", "make_mesh",
           "shard_problem_edges"]


def make_mesh(devices=None, axis: str = "edges") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def _pad_edge_arrays(ea: EdgeArrays, target: int) -> EdgeArrays:
    """Pad an edge group to `target` edges with no-op edges: indices 0,
    information = 0 (so H/b/chi2 contributions vanish identically).
    Measurements/params repeat row 0 so error kernels stay finite."""
    n = ea.measurement.shape[0]
    pad = target - n
    if pad == 0:
        return ea

    def pad0(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    def pad_repeat(x):
        return jnp.concatenate([x, jnp.repeat(x[:1], pad, axis=0)])

    return EdgeArrays(
        indices=tuple(pad0(ix) for ix in ea.indices),
        measurement=pad_repeat(ea.measurement),
        information=pad0(ea.information),   # zero info => zero weight
        delta=jnp.pad(ea.delta, (0, pad), constant_values=1.0),
        pdata=tuple(pad_repeat(p) for p in ea.pdata),
    )


def pad_problem_edges(problem: Problem, multiple: int) -> Problem:
    """Pad every edge group to a multiple of the mesh size. Padding edges have
    zero information so every derived quantity (chi2, H, b, robust rho0 for
    the DCS/Huber kernels at e2=0) contributes exactly zero."""
    new_edges = {}
    new_egroups = []
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        target = ((eg.count + multiple - 1) // multiple) * multiple
        new_edges[eg.key] = _pad_edge_arrays(ea, target)
        new_egroups.append(dataclasses.replace(eg, count=target))
    static = dataclasses.replace(problem.static, egroups=tuple(new_egroups))
    return dataclasses.replace(problem, edges=new_edges, static=static)


def _edge_pspecs(problem: Problem, axis: str):
    """PartitionSpec pytree for the edges dict: shard every leaf's leading
    (edge) axis over the mesh."""
    return jax.tree_util.tree_map(lambda _: P(axis), problem.edges)


def shard_problem_edges(problem: Problem, mesh: Mesh, axis: str = "edges") -> Problem:
    """Place a padded problem on the mesh: edge arrays sharded over their
    leading axis, vertex tables + masks replicated."""
    n = mesh.devices.size
    padded = pad_problem_edges(problem, n)
    edge_shard = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))),
        padded.edges)
    repl = NamedSharding(mesh, P())
    params = jax.tree_util.tree_map(lambda x: jax.device_put(x, repl), padded.params)
    free = jax.tree_util.tree_map(lambda x: jax.device_put(x, repl), padded.free)
    return dataclasses.replace(padded, edges=edge_shard, params=params, free=free)


def make_sharded_lm_step(problem: Problem, mesh: Mesh, axis: str = "edges",
                         max_trials: int = 10):
    """Build a jitted LM iteration whose linearize+accumulate runs
    edge-sharded over `mesh` with an explicit psum (shard_map), and whose
    solve + trial loop runs replicated.

    Returns (sharded_problem, step_fn) where
    step_fn(params, lam, ni, chi_cur) -> (params, lam, ni, chi, trials, ok).
    """
    sharded = shard_problem_edges(problem, mesh, axis)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_edge_pspecs(sharded, axis), P()),
             out_specs=(P(), P(), P()))
    def partial_system(edges_local, params):
        work = dataclasses.replace(sharded, edges=edges_local)
        lin = linearize(work, params)
        H, b, _ = build_dense_system(work, params, lin=lin, add_fixed_diag=False)
        # local robust chi2 from the local residuals
        chi = jnp.zeros((), sharded.dtype)
        for eg in sharded.static.egroups:
            resid, _, _ = lin[eg.key]
            ea = edges_local[eg.key]
            e2 = jnp.einsum("ea,eab,eb->e", resid, ea.information, resid)
            rho0, _, _ = robust_mod.robustify(eg.kernel_id, e2, ea.delta)
            chi = chi + jnp.sum(rho0)
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        chi = jax.lax.psum(chi, axis)
        return H, b, chi

    free_t, fixed_t = tangent_masks(sharded)
    fixed_diag = jnp.diag(fixed_t)
    eye_free = jnp.diag(free_t)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(_edge_pspecs(sharded, axis), P()),
             out_specs=P())
    def sharded_chi2(edges_local, params):
        work = dataclasses.replace(sharded, edges=edges_local)
        return jax.lax.psum(robust_chi2(work, params), axis)

    @jax.jit
    def step(params, lam, ni, chi_cur):
        H, b, _ = partial_system(sharded.edges, params)
        H = H + fixed_diag

        def trial_cond(st):
            trials, done, rho = st[0], st[1], st[2]
            return jnp.logical_and(jnp.logical_not(done),
                                   jnp.logical_and(rho < 0, trials < max_trials))

        def trial_body(st):
            trials, done, rho, lam, ni, best_params, best_chi = st
            dx, ok = solve_dense_cholesky(H + lam * eye_free, b)
            cand = apply_update(sharded, dx, params)
            chi_new = sharded_chi2(sharded.edges, cand)
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

        init = (jnp.int32(0), jnp.array(False), jnp.array(-1.0, sharded.dtype),
                lam, ni, params, chi_cur)
        trials, ok, rho, lam, ni, best_params, best_chi = jax.lax.while_loop(
            trial_cond, trial_body, init)
        return best_params, lam, ni, best_chi, trials, ok

    return sharded, step


def sharded_lm_optimize(problem: Problem, mesh: Mesh, iterations: int = 10,
                        tau: float = 1e-5, max_trials: int = 10,
                        verbose: bool = False):
    """Convenience driver: run `iterations` sharded LM steps. Returns
    (params, stats)."""
    sharded, step = make_sharded_lm_step(problem, mesh, max_trials=max_trials)
    H, b, raw = build_dense_system(sharded)
    lam = tau * jnp.max(jnp.abs(raw))
    ni = jnp.asarray(2.0, sharded.dtype)
    chi = robust_chi2(sharded)
    params = sharded.params
    stats = []
    for it in range(iterations):
        params, lam, ni, chi, trials, ok = step(params, lam, ni, chi)
        stats.append({"iteration": it, "chi2": float(chi),
                      "lambda": float(lam), "levenberg_iters": int(trials)})
        if verbose:
            print(f"iteration= {it}\t chi2= {float(chi):.6f}\t "
                  f"lambda= {float(lam):.6g}\t levenbergIter= {int(trials)}")
    return params, stats
