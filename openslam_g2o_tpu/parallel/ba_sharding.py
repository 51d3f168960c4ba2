"""Distributed bundle adjustment: landmark-partitioned Schur over a mesh.

The flagship multi-device configuration (ROADMAP.md, Reach item 7): each device
owns a contiguous partition of the landmarks and ALL observations of those
landmarks, so the block-diagonal landmark system (Hll, b_l, the per-edge
pose-landmark blocks W) is device-local. The reduced camera system is the
only thing reduced across the mesh:

    Hpp   = psum(local pose-pose contributions)
    b_red = b_p - psum_d( sum_{e in d} W_e (Hll^-1 b_l)_{l(e)} )
    S x   = Hpp_damped x - psum_d( local W Hll^-1 W^T x )   (inside PCG)

which is the direct analogue of the reference's OpenMP Schur loop
(block_solver.hpp:381-432) with the per-pose-block mutexes replaced by one
psum per PCG application riding ICI. Back-substitution for the landmarks
is embarrassingly local. The whole LM trial loop runs inside shard_map, so
one step is a single SPMD program.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openslam_g2o_tpu.core import robust as robust_mod
from openslam_g2o_tpu.core.problem import (
    EdgeArrays, Problem, VGroup, linearize, robust_chi2,
    _slot_tangent_indices, apply_update_parts)
from openslam_g2o_tpu.core.solvers import batched_small_inv, _tree_dot, pcg_solve

__all__ = ["partition_ba_problem", "make_sharded_ba_lm_step"]


def _lm_group(problem):
    mg = problem.static.marginalized_groups
    if len(mg) != 1:
        raise ValueError("distributed Schur expects exactly one marginalized group")
    return mg[0]


def partition_ba_problem(problem: Problem, n_dev: int):
    """Host-side partitioning: landmarks into n_dev contiguous shards, each
    landmark's observations co-located with it; pose-only edge groups sharded
    evenly. Returns (local_problem_template, sharded_arrays) where
    local_problem_template has shard-local shapes and sharded_arrays carry a
    leading device axis.
    """
    lg = _lm_group(problem)
    L = lg.count
    L_per = -(-L // n_dev)
    L_pad = L_per * n_dev

    # landmark tables -> [n_dev, L_per, ...]
    lm_params = np.asarray(problem.params[lg.name])
    lm_free = np.asarray(problem.free[lg.name])
    pad = L_pad - L
    if pad:
        lm_params = np.concatenate([lm_params,
                                    np.repeat(lm_params[:1], pad, axis=0)])
        lm_free = np.concatenate([lm_free, np.zeros(pad)])
    lm_params = lm_params.reshape(n_dev, L_per, -1)
    lm_free = lm_free.reshape(n_dev, L_per)

    new_edges = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        slot_groups = [problem.static.vgroup(g) for g in eg.slots]
        lm_slots = [s for s in range(len(slot_groups))
                    if slot_groups[s].name == lg.name]
        E = ea.measurement.shape[0]

        def np_leaf(x):
            return np.asarray(x)

        if lm_slots:
            (sl,) = lm_slots
            li = np.asarray(ea.indices[sl])
            owner = li // L_per
            order = np.argsort(owner, kind="stable")
            counts = np.bincount(owner, minlength=n_dev)
            E_per = int(counts.max()) if E else 1

            def shard_leaf(x, is_index_slot=None, fill_first=False):
                x = np.asarray(x)
                out = np.zeros((n_dev, E_per, *x.shape[1:]), dtype=x.dtype)
                if fill_first and E:
                    out[...] = x[order[0]]
                start = 0
                for d in range(n_dev):
                    n = counts[d]
                    seg = order[start:start + n]
                    out[d, :n] = x[seg]
                    start += n
                return out

            def flat(x):
                # [n_dev, E_per, ...] -> [n_dev*E_per, ...] so the shard_map
                # P(axis) spec hands each device a clean [E_per, ...] block
                return x.reshape(n_dev * E_per, *x.shape[2:])

            idx_cols = []
            for s in range(len(slot_groups)):
                col = shard_leaf(np.asarray(ea.indices[s]))
                if s == sl:
                    col = col - (np.arange(n_dev)[:, None] * L_per)
                    col = np.clip(col, 0, L_per - 1)
                idx_cols.append(jnp.asarray(flat(col).astype(np.int32)))
            info = shard_leaf(np_leaf(ea.information))  # zero padding = no-op
            meas = shard_leaf(np_leaf(ea.measurement), fill_first=True)
            delta = shard_leaf(np_leaf(ea.delta), fill_first=True)
            pdata = tuple(jnp.asarray(flat(shard_leaf(np_leaf(p), fill_first=True)))
                          for p in ea.pdata)
            new_edges[eg.key] = EdgeArrays(
                tuple(idx_cols), jnp.asarray(flat(meas)), jnp.asarray(flat(info)),
                jnp.asarray(flat(delta)), pdata)
        else:
            # pose-only edges: even split with no-op padding
            E_per = -(-max(E, 1) // n_dev)
            E_pad = E_per * n_dev

            def pad_even(x, fill_first=False, zero=False):
                x = np.asarray(x)
                extra = E_pad - E
                if extra:
                    if zero or not E:
                        tail = np.zeros((extra, *x.shape[1:]), dtype=x.dtype)
                    elif fill_first:
                        tail = np.repeat(x[:1], extra, axis=0)
                    else:
                        tail = np.zeros((extra, *x.shape[1:]), dtype=x.dtype)
                    x = np.concatenate([x, tail])
                return x.reshape(n_dev, E_per, *x.shape[1:])

            def flat2(x):
                return x.reshape(n_dev * E_per, *x.shape[2:])

            new_edges[eg.key] = EdgeArrays(
                tuple(jnp.asarray(flat2(pad_even(ix)).astype(np.int32))
                      for ix in ea.indices),
                jnp.asarray(flat2(pad_even(ea.measurement, fill_first=True))),
                jnp.asarray(flat2(pad_even(ea.information, zero=True))),
                jnp.asarray(flat2(pad_even(ea.delta, fill_first=True))),
                tuple(jnp.asarray(flat2(pad_even(p, fill_first=True)))
                      for p in ea.pdata))

    # shard-local static: landmark group resized to L_per
    new_vgroups = []
    for g in problem.static.vgroups:
        if g.name == lg.name:
            new_vgroups.append(VGroup(g.name, g.vtype, L_per, g.offset))
        else:
            new_vgroups.append(g)
    new_egroups = tuple(
        dataclasses.replace(
            eg, count=new_edges[eg.key].measurement.shape[0] // n_dev)
        for eg in problem.static.egroups)
    local_static = dataclasses.replace(
        problem.static, vgroups=tuple(new_vgroups), egroups=new_egroups,
        total_dim=problem.static.pose_dim + L_per * lg.tangent_dim)

    # host-precomputed per-shard sort permutations (flat over the device
    # axis, like the edge arrays) — keeps argsort out of the SPMD program
    lg_name = lg.name
    perms = {}
    for eg in problem.static.egroups:
        slot_groups = [problem.static.vgroup(g) for g in eg.slots]
        lm_slots = [s for s in range(len(slot_groups))
                    if slot_groups[s].name == lg_name]
        if not lm_slots:
            continue
        (sl,) = lm_slots
        ea2 = new_edges[eg.key]
        E_per = ea2.measurement.shape[0] // n_dev
        li_flat = np.asarray(ea2.indices[sl]).reshape(n_dev, E_per)
        for t in range(len(slot_groups)):
            if t == sl:
                continue
            ci_flat = np.asarray(ea2.indices[t]).reshape(n_dev, E_per)
            perm_lm = np.argsort(li_flat, axis=1, kind="stable").astype(np.int32)
            perm_cam = np.argsort(ci_flat, axis=1, kind="stable").astype(np.int32)
            li_sorted = np.take_along_axis(li_flat, perm_lm, axis=1)
            cam_sorted = np.take_along_axis(ci_flat, perm_cam, axis=1)
            perms[(eg.key, sl, t)] = {
                "perm_lm": jnp.asarray(perm_lm.reshape(-1)),
                "li_sorted": jnp.asarray(li_sorted.reshape(-1).astype(np.int32)),
                "perm_cam": jnp.asarray(perm_cam.reshape(-1)),
                "cam_sorted": jnp.asarray(cam_sorted.reshape(-1).astype(np.int32)),
            }

    shard_data = {
        "lm_params": jnp.asarray(lm_params),
        "lm_free": jnp.asarray(lm_free),
        "edges": new_edges,
        "perms": perms,
    }
    return local_static, shard_data, L_per


def make_sharded_ba_lm_step(problem: Problem, mesh: Mesh, axis: str = "lm",
                            max_trials: int = 10, pcg_iters: int = 100):
    """Build the SPMD LM step. Returns (state0, step) where
    step(pose_params, lm_params_sharded, lam, ni, chi) -> updated tuple.
    pose params replicated; landmark params sharded over `axis`."""
    lg = _lm_group(problem)
    n_dev = mesh.devices.size
    local_static, shard, L_per = partition_ba_problem(problem, n_dev)
    dl = lg.tangent_dim
    dt = problem.dtype

    pose_groups = [g for g in problem.static.vgroups if g.name != lg.name]
    Tp = problem.static.pose_dim
    pose_free = {g.name: problem.free[g.name] for g in pose_groups}

    edge_specs = jax.tree_util.tree_map(lambda _: P(axis), shard["edges"])
    perm_specs = jax.tree_util.tree_map(lambda _: P(axis), shard["perms"])

    def body(edges_local, perms_local, lm_params_local, lm_free_local,
             pose_params, lam, ni, chi_cur):
        # local sub-problem with shard-local landmark table
        params = dict(pose_params)
        params[lg.name] = lm_params_local
        free = dict(pose_free)
        free[lg.name] = lm_free_local
        local_prob = Problem(params, free, edges_local, local_static)

        lin = linearize(local_prob)
        from openslam_g2o_tpu.core.ba import (
            schur_build, _accumulate_lm, _accumulate_pose)
        sys = schur_build(local_prob, lin=lin, pattern=perms_local)
        Hpp = jax.lax.psum(sys["Hpp"], axis)
        b_p = jax.lax.psum(sys["b_p"], axis)
        Hll, b_l, cross = sys["Hll"], sys["b_l"], sys["cross"]

        free_p_parts = []
        for g in pose_groups:
            free_p_parts.append(jnp.repeat(free[g.name], g.tangent_dim))
        free_p = jnp.concatenate(free_p_parts)
        eye_l = jnp.eye(dl, dtype=dt)

        def trial_cond(st):
            trials, done, rho = st[0], st[1], st[2]
            return jnp.logical_and(jnp.logical_not(done),
                                   jnp.logical_and(rho < 0, trials < max_trials))

        def trial_body(st):
            trials, done, rho, lam, ni, best_pose, best_lm, best_chi = st
            Hll_d = Hll + (lam * lm_free_local
                           + (1.0 - lm_free_local))[:, None, None] * eye_l
            Hinv = batched_small_inv(Hll_d)
            Hpp_d = Hpp + jnp.diag(lam * free_p + (1.0 - free_p))

            hib = jnp.einsum("lst,lt->ls", Hinv, b_l)
            b_red_local = jnp.zeros_like(b_p)
            for entry in cross:
                contrib = -jnp.einsum("est,et->es", entry["W"],
                                      hib[entry["li"]])
                b_red_local = _accumulate_pose(entry, contrib, b_red_local)
            b_red = b_p + jax.lax.psum(b_red_local, axis)

            def s_matvec(x):
                y_local = jnp.zeros_like(x)
                u = jnp.zeros((L_per, dl), dtype=dt)
                for entry in cross:
                    u = u + _accumulate_lm(
                        entry, jnp.einsum("est,es->et", entry["W"],
                                          x[entry["rows"]]), L_per)
                v = jnp.einsum("lst,lt->ls", Hinv, u)
                for entry in cross:
                    contrib = -jnp.einsum("est,et->es", entry["W"],
                                          v[entry["li"]])
                    y_local = _accumulate_pose(entry, contrib, y_local)
                return Hpp_d @ x + jax.lax.psum(y_local, axis)

            # Jacobi preconditioner on the reduced diagonal (psum'd)
            corr = jnp.zeros((Tp,), dtype=dt)
            for entry in cross:
                c = -jnp.einsum("est,etu,esu->es", entry["W"],
                                Hinv[entry["li"]], entry["W"])
                corr = _accumulate_pose(entry, c, corr)
            s_diag = jnp.diagonal(Hpp_d) + jax.lax.psum(corr, axis)
            s_diag = jnp.where(jnp.abs(s_diag) < 1e-12, 1.0, s_diag)
            precond = lambda r: r / s_diag

            dx_p, ok = pcg_solve(s_matvec, b_red, precond=precond,
                                 max_iter=pcg_iters, tol=1e-10)
            dx_p = dx_p * free_p

            u = jnp.zeros((L_per, dl), dtype=dt)
            for entry in cross:
                u = u + _accumulate_lm(
                    entry, jnp.einsum("est,es->et", entry["W"],
                                      dx_p[entry["rows"]]), L_per)
            dx_l = jnp.einsum("lst,lt->ls", Hinv, b_l - u) \
                * lm_free_local[:, None]

            # apply updates: poses replicated, landmarks local
            dx_parts = {}
            for g in pose_groups:
                seg = jax.lax.dynamic_slice(dx_p, (g.offset,),
                                            (g.count * g.tangent_dim,))
                dx_parts[g.name] = seg.reshape(g.count, g.tangent_dim)
            dx_parts[lg.name] = dx_l
            cand = apply_update_parts(local_prob, dx_parts)
            chi_new = jax.lax.psum(robust_chi2(local_prob, cand), axis)
            solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
            chi_new = jnp.where(solved, chi_new, jnp.inf)

            scale_local = jnp.vdot(dx_l, lam * dx_l) + jnp.vdot(
                dx_l.reshape(-1), b_l.reshape(-1))
            scale = jnp.dot(dx_p, lam * dx_p + b_p) \
                + jax.lax.psum(scale_local, axis) + 1e-3
            rho = jnp.where(solved, (chi_cur - chi_new) / scale, -1.0)
            accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            good = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
            lam = jnp.where(accept, lam * good, lam * ni)
            ni = jnp.where(accept, 2.0, ni * 2.0)
            sel = lambda new, old: jnp.where(accept, new, old)
            best_pose = {g.name: sel(cand[g.name], best_pose[g.name])
                         for g in pose_groups}
            best_lm = sel(cand[lg.name], best_lm)
            best_chi = jnp.where(accept, chi_new, best_chi)
            return (trials + 1, accept, rho, lam, ni, best_pose, best_lm,
                    best_chi)

        init = (jnp.int32(0), jnp.array(False), jnp.array(-1.0, dt),
                lam, ni, dict(pose_params), lm_params_local, chi_cur)
        (trials, ok, rho, lam, ni, best_pose, best_lm,
         best_chi) = jax.lax.while_loop(trial_cond, trial_body, init)
        return best_pose, best_lm, lam, ni, best_chi, trials, ok

    pose_spec = {g.name: P() for g in pose_groups}
    step = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(edge_specs, perm_specs, P(axis), P(axis), pose_spec,
                  P(), P(), P()),
        out_specs=(pose_spec, P(axis), P(), P(), P(), P(), P())))

    # device placement
    ndev_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    edges_dev = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, P(axis, *([None] * (x.ndim - 1))))), shard["edges"])
    perms_dev = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(axis))),
        shard["perms"])
    lm_params0 = jax.device_put(
        shard["lm_params"].reshape(-1, shard["lm_params"].shape[-1]),
        NamedSharding(mesh, P(axis, None)))
    lm_free0 = jax.device_put(shard["lm_free"].reshape(-1),
                              NamedSharding(mesh, P(axis)))
    pose_params0 = {g.name: jax.device_put(problem.params[g.name], repl)
                    for g in pose_groups}

    def run_step(pose_params, lm_params, lam, ni, chi):
        return step(edges_dev, perms_dev, lm_params, lm_free0, pose_params,
                    lam, ni, chi)

    state0 = {
        "pose_params": pose_params0,
        "lm_params": lm_params0,
        "lm_free": lm_free0,
        "L_per": L_per,
    }
    return state0, run_step
