"""The compiled, device-resident optimization problem.

This module replaces the reference's pointer-wired runtime core — the active
vertex/edge sets and Hessian index of SparseOptimizer
(g2o/core/sparse_optimizer.cpp:166-263), the per-edge virtual
computeError/linearizeOplus/constructQuadraticForm dispatch
(g2o/core/base_binary_edge.hpp:55-205), and the memory-mapped block Hessian
(g2o/core/block_solver.hpp:143-295) — with a struct-of-arrays pytree:

* vertices grouped by type into ``[N, P]`` parameter tables,
* edges grouped by (type, robust kernel) into index/measurement/information
  tables,
* one global tangent vector of dimension ``total_dim`` laid out group by
  group; fixed vertices keep their slots but are *masked* (their Jacobian
  columns are zeroed and the Hessian diagonal gets a 1), replacing the
  reference's hessianIndex == -1 convention,
* errors via a single vmap per edge group and Jacobians via jax.jacfwd on the
  tangent increment (replacing both the numeric central differences of
  base_binary_edge.hpp:131-205 and the hand-derived analytic Jacobians).

Everything here is jit-compatible; the static shape/type info travels in the
pytree's aux data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from openslam_g2o_tpu.core.solvers import batched_small_inv

from openslam_g2o_tpu.core import registry, robust

__all__ = [
    "Problem", "EdgeArrays", "VGroup", "EGroup", "ProblemStatic",
    "build_problem", "compute_errors", "edge_chi2", "chi2", "robust_chi2",
    "linearize", "build_dense_system", "apply_update", "tangent_masks",
    "write_back",
]


# ---------------------------------------------------------------------------
# Static (aux) metadata
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VGroup:
    """One vertex type's table: N vertices, tangent block at [offset,
    offset + N*D) in the global tangent vector."""
    name: str
    vtype: registry.VertexType
    count: int
    offset: int

    @property
    def tangent_dim(self):
        return self.vtype.tangent_dim

    @property
    def tangent_size(self):
        return self.count * self.vtype.tangent_dim


@dataclass(frozen=True)
class EGroup:
    """One (edge type, robust kernel) group's static info."""
    key: str
    etype: registry.EdgeType
    kernel_id: int
    count: int

    @property
    def slots(self):
        return self.etype.vertex_types


@dataclass(frozen=True)
class ProblemStatic:
    vgroups: tuple
    egroups: tuple
    total_dim: int
    # tangent dims [0, pose_dim) belong to non-marginalized groups; groups at
    # [pose_dim, total_dim) are marginalizable (Schur-eliminated landmarks).
    # Mirrors buildIndexMapping's poses-first ordering
    # (sparse_optimizer.cpp:166-190).
    pose_dim: int = -1

    def __post_init__(self):
        if self.pose_dim < 0:
            object.__setattr__(self, "pose_dim", self.total_dim)

    def vgroup(self, name: str) -> VGroup:
        for g in self.vgroups:
            if g.name == name:
                return g
        raise KeyError(name)

    @property
    def marginalized_groups(self):
        return tuple(g for g in self.vgroups if g.offset >= self.pose_dim)


# ---------------------------------------------------------------------------
# Pytree data
# ---------------------------------------------------------------------------

@partial(jax.tree_util.register_dataclass,
         data_fields=["indices", "measurement", "information", "delta", "pdata"],
         meta_fields=[])
@dataclass
class EdgeArrays:
    indices: tuple          # per slot: [E] int32 local indices into the vertex table
    measurement: jnp.ndarray  # [E, M]
    information: jnp.ndarray  # [E, D, D]
    delta: jnp.ndarray        # [E] robust kernel width
    pdata: tuple              # per parameter slot: [E, Pd] gathered parameter data


@partial(jax.tree_util.register_dataclass,
         data_fields=["params", "free", "edges"],
         meta_fields=["static"])
@dataclass
class Problem:
    params: dict            # group name -> [N, P]
    free: dict              # group name -> [N] (1.0 = free, 0.0 = fixed)
    edges: dict             # egroup key -> EdgeArrays
    static: ProblemStatic

    @property
    def total_dim(self):
        return self.static.total_dim

    @property
    def dtype(self):
        return next(iter(self.params.values())).dtype

    def with_params(self, params: dict) -> "Problem":
        return dataclasses.replace(self, params=params)


# ---------------------------------------------------------------------------
# Lowering from the host graph
# ---------------------------------------------------------------------------

def build_problem(graph, dtype=None, level: int = 0,
                  pad_counts=None) -> Problem:
    """Lower the host graph to a device Problem.

    pad_counts: optional callable n -> padded_n applied to every vertex and
    edge table size. Used by the online/incremental optimizer to keep array
    shapes in a small set of buckets so jit caches hit as the graph grows
    (the accelerator answer to the reference's incremental CHOLMOD rank
    updates,
    graph_optimizer_sparse_incremental.cpp:194-420 — recompilation amortizes
    away, re-solves are warm-started). Padding vertices are fixed at the
    origin; padding edges have zero information, so neither contributes.
    """
    if dtype is None:
        dtype = jnp.zeros((), jnp.float64).dtype  # f64 if x64 enabled else f32
    pad = pad_counts if pad_counts is not None else (lambda n: n)

    # --- vertex groups, in first-seen order; marginalizable (landmark)
    # groups are laid out last in the tangent vector, poses first, matching
    # buildIndexMapping (sparse_optimizer.cpp:166-190)
    order: dict[str, list] = {}
    local_index: dict[int, tuple] = {}
    for vid, rec in graph.vertices.items():
        order.setdefault(rec.vtype.name, []).append(rec)
    group_names = sorted(order, key=lambda n: order[n][0].vtype.marginalizable)
    order = {n: order[n] for n in group_names}
    pose_dim = sum(pad(len(recs)) * recs[0].vtype.tangent_dim
                   for recs in order.values()
                   if not recs[0].vtype.marginalizable)
    vgroups = []
    params = {}
    free = {}
    offset = 0
    for name, recs in order.items():
        vt = recs[0].vtype
        for i, rec in enumerate(recs):
            local_index[rec.vid] = (name, i)
        n_pad = pad(len(recs))
        p = np.stack([r.params for r in recs]).astype(np.float64)
        f = np.array([0.0 if r.fixed else 1.0 for r in recs])
        if n_pad > len(recs):
            origin = np.asarray(vt.origin(jnp.float64), dtype=np.float64)
            p = np.concatenate(
                [p, np.tile(origin, (n_pad - len(recs), 1))])
            f = np.concatenate([f, np.zeros(n_pad - len(recs))])
        params[name] = jnp.asarray(p, dtype=dtype)
        free[name] = jnp.asarray(f, dtype=dtype)
        vgroups.append(VGroup(name, vt, n_pad, offset))
        offset += n_pad * vt.tangent_dim

    # --- edge groups keyed by (type, kernel)
    buckets: dict[tuple, list] = {}
    for e in graph.edges:
        if e.level != level:
            continue
        kid = robust.kernel_id(e.kernel)
        buckets.setdefault((e.etype.name, kid), []).append(e)

    egroups = []
    edges = {}
    for (tname, kid), recs in buckets.items():
        et = recs[0].etype
        key = tname if kid == robust.NONE_ID else f"{tname}#{robust.kernel_names()[kid]}"
        n_pad = pad(len(recs))
        extra = n_pad - len(recs)
        idx_cols = []
        for s in range(et.num_vertices):
            col = np.zeros(n_pad, dtype=np.int32)
            for i, r in enumerate(recs):
                gname, li = local_index[r.vertex_ids[s]]
                col[i] = li
            idx_cols.append(jnp.asarray(col))

        def padded(stack, fill=None):
            # Padding rows repeat row 0 (a VALID measurement/parameter) so the
            # error kernel stays finite on them — their information is zero,
            # so they contribute nothing, but a zeros-row could produce
            # NaN/inf (e.g. z=0 in a projection) that would poison the sums.
            if extra == 0:
                return stack
            row = stack[:1] if fill is None else fill
            return np.concatenate([stack, np.repeat(row, extra, axis=0)])

        meas = np.stack([r.measurement for r in recs])
        info = np.stack([r.information for r in recs])
        meas = jnp.asarray(padded(meas), dtype=dtype)
        info = jnp.asarray(padded(info, np.zeros((1, *info.shape[1:]))),
                           dtype=dtype)
        delta = np.array([r.kernel_delta for r in recs])
        delta = jnp.asarray(np.concatenate([delta, np.ones(extra)]), dtype=dtype)
        pdata = []
        for ps in range(len(et.param_types)):
            vals = np.stack([graph.parameters[r.param_ids[ps]][1] for r in recs])
            pdata.append(jnp.asarray(padded(vals), dtype=dtype))
        edges[key] = EdgeArrays(tuple(idx_cols), meas, info, delta, tuple(pdata))
        egroups.append(EGroup(key, et, kid, n_pad))

    static = ProblemStatic(tuple(vgroups), tuple(egroups), offset, pose_dim)
    return Problem(params, free, edges, static)


def edge_group_rows(graph, level: int = 0):
    """For each edge in graph.edges (in order), the (egroup key, row) it
    lands on in build_problem's type/kernel bucketing — the host-side map
    from graph edges to Problem table rows. Edges on other levels map to
    None."""
    counts: dict = {}
    out = []
    for e in graph.edges:
        if e.level != level:
            out.append(None)
            continue
        kid = robust.kernel_id(e.kernel)
        key = e.etype.name if kid == robust.NONE_ID \
            else f"{e.etype.name}#{robust.kernel_names()[kid]}"
        row = counts.get(key, 0)
        counts[key] = row + 1
        out.append((key, row))
    return out


def write_back(problem: Problem, graph) -> None:
    """Copy optimized estimates back into the host graph records."""
    order: dict[str, list] = {}
    for vid, rec in graph.vertices.items():
        order.setdefault(rec.vtype.name, []).append(rec)
    for name, recs in order.items():
        vals = np.asarray(problem.params[name], dtype=np.float64)
        for i, rec in enumerate(recs):
            rec.params = vals[i]


# ---------------------------------------------------------------------------
# Errors / chi2
# ---------------------------------------------------------------------------

def _gather_vertex_params(eg: EGroup, ea: EdgeArrays, params: dict):
    return tuple(params[g][ea.indices[s]] for s, g in enumerate(eg.slots))


def compute_errors(problem: Problem, params: Optional[dict] = None) -> dict:
    """Residuals per edge group: the vmapped analogue of
    SparseOptimizer::computeActiveErrors (sparse_optimizer.cpp:61-88)."""
    params = problem.params if params is None else params
    out = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        vp = _gather_vertex_params(eg, ea, params)
        err = jax.vmap(lambda v, m, p: eg.etype.error(v, m, p))(
            vp, ea.measurement, ea.pdata)
        out[eg.key] = err
    return out


def edge_chi2(problem: Problem, errors: Optional[dict] = None,
              params: Optional[dict] = None) -> dict:
    """Per-edge squared Mahalanobis error e^T Omega e (base_edge.h:58)."""
    if errors is None:
        errors = compute_errors(problem, params)
    out = {}
    for eg in problem.static.egroups:
        r = errors[eg.key]
        ea = problem.edges[eg.key]
        out[eg.key] = jnp.einsum("ea,eab,eb->e", r, ea.information, r)
    return out


def chi2(problem: Problem, params: Optional[dict] = None):
    """Non-robust chi2 (activeChi2, sparse_optimizer.cpp:90-98)."""
    e2 = edge_chi2(problem, params=params)
    return sum(jnp.sum(v) for v in e2.values())


def robust_chi2(problem: Problem, params: Optional[dict] = None):
    """Robust chi2: sum of rho(e2) (activeRobustChi2, sparse_optimizer.cpp:100-114)."""
    e2 = edge_chi2(problem, params=params)
    total = jnp.zeros((), problem.dtype)
    for eg in problem.static.egroups:
        rho0, _, _ = robust.robustify(eg.kernel_id, e2[eg.key],
                                      problem.edges[eg.key].delta)
        total = total + jnp.sum(rho0)
    return total


# ---------------------------------------------------------------------------
# Linearization
# ---------------------------------------------------------------------------

def _tangent_residual_fn(eg: EGroup):
    """error as a function of tangent increments around the linearization
    point — what jacfwd differentiates (the manifold-aware analogue of
    linearizeOplus, base_binary_edge.hpp:123-205)."""
    vtypes = tuple(registry.vertex_type(n) for n in eg.slots)
    error = eg.etype.error

    def fn(deltas, vparams, meas, pdata):
        vp = tuple(vt.retract(p, d) for vt, p, d in zip(vtypes, vparams, deltas))
        return error(vp, meas, pdata)

    return fn


def linearize(problem: Problem, params: Optional[dict] = None) -> dict:
    """For each edge group: residual [E, D], per-slot Jacobians [E, D, Ds]
    wrt the tangent increment, and robust weights rho' [E].

    Fixed-vertex masking is applied here: Jacobian columns of fixed vertices
    are zeroed, so their contributions vanish from H and b (the mask-based
    replacement for hessianIndex == -1, sparse_optimizer.cpp:177-188).
    """
    params = problem.params if params is None else params
    out = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        vp = _gather_vertex_params(eg, ea, params)
        vtypes = tuple(registry.vertex_type(n) for n in eg.slots)

        resid = jax.vmap(lambda v, m, p: eg.etype.error(v, m, p))(
            vp, ea.measurement, ea.pdata)

        n_edges = ea.measurement.shape[0]  # shard-local count under shard_map
        if eg.etype.jacobian is not None:
            jacs = jax.vmap(lambda v, m, p: eg.etype.jacobian(v, m, p))(
                vp, ea.measurement, ea.pdata)
            jacs = tuple(jacs)
        else:
            fn = _tangent_residual_fn(eg)
            zeros = tuple(
                jnp.zeros((n_edges, vt.tangent_dim), dtype=problem.dtype)
                for vt in vtypes)
            jacs = jax.vmap(jax.jacfwd(fn, argnums=0))(
                zeros, vp, ea.measurement, ea.pdata)

        # robust weights (rho'): scales Omega in the quadratic form
        # (BaseEdge::robustInformation, base_edge.h:96-99)
        e2 = jnp.einsum("ea,eab,eb->e", resid, ea.information, resid)
        _, rho1, _ = robust.robustify(eg.kernel_id, e2, ea.delta)

        # zero out columns of fixed vertices
        masked = []
        for s, g in enumerate(eg.slots):
            m = problem.free[g][ea.indices[s]]
            masked.append(jacs[s] * m[:, None, None])
        out[eg.key] = (resid, tuple(masked), rho1)
    return out


# ---------------------------------------------------------------------------
# Dense system assembly
# ---------------------------------------------------------------------------

def tangent_masks(problem: Problem):
    """(free_t, fixed_t): per-tangent-slot masks as [total_dim] vectors."""
    free_parts = []
    for g in problem.static.vgroups:
        f = problem.free[g.name]
        free_parts.append(jnp.repeat(f, g.tangent_dim))
    free_t = jnp.concatenate(free_parts) if free_parts else jnp.zeros((0,), problem.dtype)
    return free_t, 1.0 - free_t


def _slot_tangent_indices(g: VGroup, idx):
    """Global tangent indices for each edge's slot: [E, D]."""
    base = g.offset + idx.astype(jnp.int32) * g.tangent_dim
    return base[:, None] + jnp.arange(g.tangent_dim, dtype=jnp.int32)[None, :]


def build_dense_system(problem: Problem, params: Optional[dict] = None,
                       lin: Optional[dict] = None, add_fixed_diag: bool = True):
    """Assemble the full dense H = J^T W J and b = -J^T W r over the global
    tangent vector.

    The JAX replacement for BlockSolver::buildSystem's zero-copy
    mapped-memory accumulation (block_solver.hpp:502-560): per-edge blocks are
    batched einsums scattered into H with jnp scatter-add (deterministic, no
    per-vertex locks needed — compare openmp_mutex.h).

    Returns (H, b, raw_diag) where raw_diag excludes the +1 regularization of
    fixed slots — it is what LM's lambda-init scans
    (optimization_algorithm_levenberg.cpp:149-163).
    """
    T = problem.static.total_dim
    dt = problem.dtype
    if lin is None:
        lin = linearize(problem, params)
    H = jnp.zeros((T, T), dtype=dt)
    b = jnp.zeros((T,), dtype=dt)
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        resid, jacs, w = lin[eg.key]
        w_omega = w[:, None, None] * ea.information       # [E, D, D]
        slot_idx = []
        for s, gname in enumerate(eg.slots):
            g = problem.static.vgroup(gname)
            slot_idx.append(_slot_tangent_indices(g, ea.indices[s]))
        k = eg.etype.num_vertices
        for s in range(k):
            js_w = jnp.einsum("eas,eab->esb", jacs[s], w_omega)  # [E, Ds, D]
            b_blk = -jnp.einsum("esb,eb->es", js_w, resid)
            b = b.at[slot_idx[s]].add(b_blk)
            for t in range(s, k):
                blk = jnp.einsum("esb,ebt->est", js_w, jacs[t])  # [E, Ds, Dt]
                H = H.at[slot_idx[s][:, :, None], slot_idx[t][:, None, :]].add(blk)
                if t != s:
                    H = H.at[slot_idx[t][:, :, None], slot_idx[s][:, None, :]].add(
                        jnp.swapaxes(blk, 1, 2))
    raw_diag = jnp.diagonal(H)
    if add_fixed_diag:
        _, fixed_t = tangent_masks(problem)
        H = H + jnp.diag(fixed_t)  # unit diagonal on fixed slots keeps H SPD
    return H, b, raw_diag


# ---------------------------------------------------------------------------
# Matrix-free Hessian operator (for PCG)
# ---------------------------------------------------------------------------

def hessian_operator(problem: Problem, lin: dict):
    """Return (matvec, diag_blocks, b) where matvec(x) = H x applied
    edge-wise — H = sum_e J_e^T W_e J_e is never materialized, each
    application is two gathers + one scatter-add per slot pair (O(E) work,
    the JAX analogue of BlockSolverBase::multiplyHessian,
    block_solver.h:90), and diag_blocks[group] is the [N, D, D] block
    diagonal for block-Jacobi preconditioning (linear_solver_pcg.h:47).
    """
    dt = problem.dtype
    T = problem.static.total_dim
    b = jnp.zeros((T,), dtype=dt)
    diag_blocks = {
        g.name: jnp.zeros((g.count, g.tangent_dim, g.tangent_dim), dtype=dt)
        for g in problem.static.vgroups}
    terms = []  # (rows_s, rows_t, A_st [E, Ds, Dt]) meaning y[rows_s] += A x[rows_t]

    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        resid, jacs, w = lin[eg.key]
        w_omega = w[:, None, None] * ea.information
        k = eg.etype.num_vertices
        groups = [problem.static.vgroup(g) for g in eg.slots]
        idx = [_slot_tangent_indices(groups[s], ea.indices[s]) for s in range(k)]
        for s in range(k):
            js_w = jnp.einsum("eas,eab->esb", jacs[s], w_omega)
            b = b.at[idx[s]].add(-jnp.einsum("esb,eb->es", js_w, resid))
            for t in range(s, k):
                blk = jnp.einsum("esb,ebt->est", js_w, jacs[t])
                terms.append((idx[s], idx[t], blk))
                if t != s:
                    terms.append((idx[t], idx[s], jnp.swapaxes(blk, 1, 2)))
                else:
                    diag_blocks[groups[s].name] = (
                        diag_blocks[groups[s].name].at[ea.indices[s]].add(blk))

    _, fixed_t = tangent_masks(problem)

    def matvec(x):
        y = fixed_t * x  # unit diagonal on fixed slots
        for rows_s, rows_t, blk in terms:
            y = y.at[rows_s].add(jnp.einsum("est,et->es", blk, x[rows_t]))
        return y

    return matvec, diag_blocks, b


def block_jacobi_preconditioner(problem: Problem, diag_blocks: dict, lam):
    """Batched inverse of the damped block diagonal; returns precond(r) over
    per-group part dicts (pure batched einsums — no gather/scatter in the
    PCG loop). Fixed vertices get identity blocks."""
    dt = problem.dtype
    invs = {}
    for g in problem.static.vgroups:
        D = g.tangent_dim
        eye = jnp.eye(D, dtype=dt)
        free = problem.free[g.name]
        blocks = (diag_blocks[g.name] + lam * eye[None]) * free[:, None, None] \
            + (1.0 - free)[:, None, None] * eye[None]
        invs[g.name] = batched_small_inv(blocks)

    def precond(r: dict):
        # elementwise multiply + reduce, not einsum: XLA lowers batched tiny
        # dots to tiny matmul calls (see core/sparse.bmm_small)
        return {name: (invs[name] * r[name][:, None, :]).sum(-1)
                for name in r}

    return precond


def block_jacobi_preconditioner_lane(problem: Problem, diag_blocks: dict,
                                     lam):
    """Lane-major block-Jacobi preconditioner: applies to dicts of [D, N]
    parts with the inverse blocks pre-transposed to [D, D, N], so the PCG hot
    loop's precondition step is a single elementwise multiply-reduce with no per-call
    transposes."""
    dt = problem.dtype
    invs = {}
    for g in problem.static.vgroups:
        D = g.tangent_dim
        eye = jnp.eye(D, dtype=dt)
        free = problem.free[g.name]
        blocks = (diag_blocks[g.name] + lam * eye[None]) * free[:, None, None] \
            + (1.0 - free)[:, None, None] * eye[None]
        invs[g.name] = jnp.moveaxis(batched_small_inv(blocks), 0, -1)

    def precond(rT: dict):
        # y[s, n] = sum_t inv[s, t, n] r[t, n]
        return {name: (invs[name] * rT[name][None]).sum(1) for name in rT}

    return precond


def apply_update_parts(problem: Problem, dx_parts: dict,
                       params: Optional[dict] = None) -> dict:
    """apply_update for per-group part dicts (dx as [N, D] per group)."""
    params = problem.params if params is None else params
    new_params = {}
    for g in problem.static.vgroups:
        delta = dx_parts[g.name] * problem.free[g.name][:, None]
        new_params[g.name] = jax.vmap(g.vtype.retract)(params[g.name], delta)
    return new_params


# ---------------------------------------------------------------------------
# Update (oplus)
# ---------------------------------------------------------------------------

def apply_update(problem: Problem, dx, params: Optional[dict] = None) -> dict:
    """params <- retract(params, dx), dx masked on fixed vertices.

    The batched analogue of SparseOptimizer::update
    (sparse_optimizer.cpp:421-434).
    """
    params = problem.params if params is None else params
    new_params = {}
    for g in problem.static.vgroups:
        D = g.tangent_dim
        seg = jax.lax.dynamic_slice(dx, (g.offset,), (g.count * D,))
        delta = seg.reshape(g.count, D) * problem.free[g.name][:, None]
        new_params[g.name] = jax.vmap(g.vtype.retract)(params[g.name], delta)
    return new_params
