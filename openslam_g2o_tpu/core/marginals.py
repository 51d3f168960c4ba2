"""Marginal covariance recovery: selected blocks of H^-1.

JAX replacement for MarginalCovarianceCholesky
(g2o/core/marginal_covariance_cholesky.h:50-103) and
SparseOptimizer::computeMarginals (g2o/core/sparse_optimizer.h:131-160).

The reference recovers entries of H^-1 from a sparse Cholesky factor with
Takahashi-style recursion + hash memoization — a pointer-chasing algorithm
that does not vectorize. Here the factor is the dense Cholesky of H (cheap at
pose-graph scale), and selected covariance columns come from batched
triangular solves: Cov[:, J] = L^-T (L^-1 I[:, J]) — one big batched
solve instead of a recursive walk. For the Schur/BA configuration, pose
covariances solve against the reduced system S and landmark blocks use the
standard back-substitution identity
Cov_ll = Hll^-1 + Hll^-1 W^T Cov_pp W Hll^-1 (restricted to the requested
blocks), so the landmark system is never inverted globally.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from openslam_g2o_tpu.core.problem import (
    Problem, build_dense_system, linearize, tangent_masks)

__all__ = ["compute_marginals", "compute_marginals_all_diagonal",
           "compute_marginals_schur", "compute_marginals_pairs"]


def _vertex_slices(problem: Problem, graph, vertex_ids):
    """(offset, dim) of each requested vertex in the global tangent vector."""
    order = {}
    for vid, rec in graph.vertices.items():
        order.setdefault(rec.vtype.name, []).append(vid)
    local = {}
    for name, vids in order.items():
        for i, vid in enumerate(vids):
            local[vid] = (name, i)
    out = []
    for vid in vertex_ids:
        name, li = local[vid]
        g = problem.static.vgroup(name)
        out.append((g.offset + li * g.tangent_dim, g.tangent_dim))
    return out


def compute_marginals(problem: Problem, graph, vertex_ids: Sequence[int],
                      method: str = "auto"):
    """Covariance blocks of the requested vertices (diagonal blocks of H^-1
    restricted to their tangent dims). Returns {vertex_id: np[D, D]}.

    Equivalent to computeMarginals with per-vertex block indices
    (sparse_optimizer.h:131-160); fixed vertices get zero covariance (they
    are not in the reference's index mapping at all).

    method: "auto" routes problems with a marginalized (landmark) group
    through the Schur path — the dense H of a BA problem would not fit in
    HBM; "dense" forces the full-H Cholesky.
    """
    if method == "auto" and problem.static.pose_dim < problem.static.total_dim:
        diag = compute_marginals_schur(problem)
        order: dict = {}
        for vid, rec in graph.vertices.items():
            order.setdefault(rec.vtype.name, []).append(vid)
        local = {}
        for name, vids in order.items():
            for i, vid in enumerate(vids):
                local[vid] = (name, i)
        return {vid: np.asarray(diag[local[vid][0]][local[vid][1]])
                for vid in vertex_ids}
    H, _, _ = build_dense_system(problem)
    L = jnp.linalg.cholesky(H)
    slices = _vertex_slices(problem, graph, vertex_ids)

    # gather all requested columns at once -> one batched triangular solve
    cols = np.concatenate([np.arange(off, off + d) for off, d in slices])
    T = problem.static.total_dim
    rhs = jnp.zeros((T, len(cols)), dtype=problem.dtype)
    rhs = rhs.at[jnp.asarray(cols), jnp.arange(len(cols))].set(1.0)
    y = solve_triangular(L, rhs, lower=True)
    X = solve_triangular(L.T, y, lower=False)       # H^-1 [:, cols]

    free_t, _ = tangent_masks(problem)
    X = X * free_t[:, None]

    out = {}
    pos = 0
    for vid, (off, d) in zip(vertex_ids, slices):
        blk = X[off:off + d, pos:pos + d]
        out[vid] = np.asarray(blk)
        pos += d
    return out


def compute_marginals_pairs(problem: Problem, graph, pairs):
    """Arbitrary (vertex_i, vertex_j) blocks of H^-1: {(vi, vj): np[Di, Dj]}.

    The CLI's -computeMarginals surface (g2o.cpp:556-583 requests the
    (hessianIndex, hessianIndex) diagonal blocks plus the (i-1, i)
    off-diagonals): the reference recovers them from the CHOLMOD factor via
    MarginalCovarianceCholesky; here one dense Cholesky + a batched
    triangular solve against the UNION of requested columns yields every
    requested block — all rows of H^-1[:, cols] come out of the same solve,
    so off-diagonal blocks are free once the columns are solved."""
    col_vids = sorted({vj for _, vj in pairs})
    slices_j = dict(zip(col_vids, _vertex_slices(problem, graph, col_vids)))
    H, _, _ = build_dense_system(problem)
    L = jnp.linalg.cholesky(H)
    cols = np.concatenate([np.arange(off, off + d)
                           for off, d in (slices_j[v] for v in col_vids)])
    col_pos = {}
    pos = 0
    for v in col_vids:
        col_pos[v] = pos
        pos += slices_j[v][1]
    T = problem.static.total_dim
    rhs = jnp.zeros((T, len(cols)), dtype=problem.dtype)
    rhs = rhs.at[jnp.asarray(cols), jnp.arange(len(cols))].set(1.0)
    y = solve_triangular(L, rhs, lower=True)
    X = solve_triangular(L.T, y, lower=False)        # H^-1 [:, cols]
    free_t, _ = tangent_masks(problem)
    X = np.asarray(X * free_t[:, None])

    row_vids = sorted({vi for vi, _ in pairs})
    slices_i = dict(zip(row_vids, _vertex_slices(problem, graph, row_vids)))
    out = {}
    for vi, vj in pairs:
        off_i, di = slices_i[vi]
        pj = col_pos[vj]
        dj = slices_j[vj][1]
        out[(vi, vj)] = X[off_i:off_i + di, pj:pj + dj]
    return out


_DEVICE_JIT = None


def _device_products(problem, pattern):
    """linearize + ba_ell._build as ONE cached jitted program (a
    per-call jit of a locally-defined function would recompile every
    invocation)."""
    global _DEVICE_JIT
    if _DEVICE_JIT is None:
        from openslam_g2o_tpu.core.ba_ell import _build

        def f(p, pat):
            l = linearize(p)
            s = _build(p, pat, l)
            # the marginals dense route re-densifies B2 from the W tables
            # in HOST f64 (see below) — dropping the device B2 from the
            # program's outputs lets XLA dead-code-eliminate its one-hot
            # einsum and the 72 MB (80k shape) of HBM it would occupy
            return l, {**s, "B2": None}

        _DEVICE_JIT = jax.jit(f)
    return _DEVICE_JIT(problem, pattern)


def _pair_tiles(K: int, tile: int = 32):
    """Static (k0, k1) tile pairs covering the [K, K] neighbor-pair square —
    bounds peak memory of the L x K x K block tensors at BA scale."""
    starts = list(range(0, K, tile))
    return [(a, min(a + tile, K)) for a in starts]


def compute_marginals_schur(problem: Problem, pattern=None, lin=None,
                            sys=None):
    """See _compute_marginals_schur_impl. Runs under
    default_matmul_precision('highest'): at the default precision a
    float32 matmul/einsum may run in reduced precision (TF32 on the GPU's
    tensor cores), and the UNDAMPED reduced system here sits one pinned
    gauge away from singular — reduced-precision noise can make it
    indefinite and the factorization NaN. The covariance path is
    seconds-scale, so the slower full-precision matmuls cost little.

    lin/sys: optional precomputed linearization / _build products. A
    verification harness MUST pass the same objects it derives its
    reference from: two separate f32 evaluations of the 8e4-term Hcc
    reductions differ by ~sqrt(E)*eps between fusion orders (eager vs
    jitted), and the ~1e3-effective-conditioned S inverse amplifies that
    to ~1e-2 in the recovered blocks, a phantom error even when every
    genuine route input (W, B2, Hinv) is equal."""
    with jax.default_matmul_precision("highest"):
        return _compute_marginals_schur_impl(problem, pattern, lin, sys)


def _compute_marginals_schur_impl(problem: Problem, pattern=None, lin=None,
                                  sys=None):
    """All per-vertex diagonal covariance blocks at BA scale WITHOUT the
    dense H: {group: [N, D, D]}.

    The Schur-path identity the reference exploits through its factor
    recursion (marginal_covariance_cholesky.h:50-103), here in block form:
    with H = [[Hpp, W], [W^T, Hll]] and S = Hpp - W Hll^-1 W^T,

        Cov_pp      = S^-1                       (reduced pose system)
        Cov_ll(j)   = Hll_j^-1 + Hll_j^-1 B_j^T S^-1 B_j Hll_j^-1

    where B_j = W[:, j] has nonzero blocks only at the cameras observing
    landmark j — exactly the landmark-major ELL rows of core/ba_ell.py. S
    itself is dense [Tp, Tp] (pose tangent dims), the object the reference
    also factorizes; its MXU Cholesky replaces CHOLMOD. Fixed vertices get
    zero covariance (hessianIndex == -1 semantics,
    sparse_optimizer.cpp:177-188).

    Two assembly routes, chosen by the same predicate as the solver
    (ba_ell.dense_schur_ok): when the one-hot densify operand exists, the
    coupling terms are THREE matmuls on the dense B = W [Tp, dl*L] —
    S -= B Hll^-1 B^T, and corr_l = (B^T S^-1 B)_ll via M = S^-1 B — with
    no gathers or scatters anywhere (the route is bounded by ~2
    [Tp, dl*L] matmuls).
    The tiled K x K route remains as the beyond-gate fallback.
    """
    from openslam_g2o_tpu.core.ba_ell import (
        _build, _eye_lane, _inv_lane, build_ba_ell_pattern, dense_schur_ok)
    from openslam_g2o_tpu.core.solvers import batched_small_inv

    if pattern is None:
        pattern = build_ba_ell_pattern(problem)
    dt = problem.dtype
    if lin is None or sys is None:
        # ONE jitted device program for the whole O(E) phase: the eager
        # form pays one dispatch per op
        lin, sys = _device_products(problem, pattern)
    L, dl, Tp = sys["L"], sys["dl"], sys["Tp"]
    lg = problem.static.vgroup(pattern.lm_name)
    free_l = problem.free[lg.name]
    eye_l = jnp.eye(dl, dtype=dt)
    # undamped; fixed landmarks carry identity blocks (their W rows are
    # already masked to zero by linearize). _build returns lane-major
    # [dl, dl, L] stacks (the ba_ell hot-loop layout).
    Hll_d_lane = sys["Hll"] + _eye_lane(dl, dt) * (1.0 - free_l)[None, None]

    pose_groups = [g for g in problem.static.vgroups
                   if g.offset < problem.static.pose_dim]
    # route predicate: dense_schur_ok alone — _build computes its device
    # B2 iff the same predicate holds, and this path only ever consumes
    # the HOST-f64 re-densified B2r, never the device operand (which
    # _device_products drops so XLA can eliminate it)
    use_dense = dense_schur_ok(problem, pattern)
    if not use_dense:
        # f32 on-device landmark inverses (the dense route inverts in host
        # f64 instead — see below)
        Hinv_lane = _inv_lane(Hll_d_lane)                # [dl, dl, L]
        Hinv = jnp.moveaxis(Hinv_lane, -1, 0)            # [L, dl, dl]

    # ---- dense reduced system S over the pose tangent block -------------
    S = jnp.zeros((Tp, Tp), dtype=dt)
    for g in pose_groups:
        D = g.tangent_dim
        base = jnp.moveaxis(sys["groups"].get(g.name, {"Hcc": jnp.zeros(
            (D, D, g.count), dt)})["Hcc"], -1, 0)        # [C, D, D]
        f = problem.free[g.name]
        blocks = base * f[:, None, None] \
            + (1.0 - f)[:, None, None] * jnp.eye(D, dtype=dt)[None]
        gidx = (g.offset + jnp.arange(g.count)[:, None] * D
                + jnp.arange(D)[None, :])
        S = S.at[gidx[:, :, None], gidx[:, None, :]].add(blocks)
    if sys["has_extra"]:
        S = S + sys["Hpp_extra"]

    def cam_offsets(pg):
        g = problem.static.vgroup(pg.cam_group)
        return g.offset, g.tangent_dim

    # subtract W Hll^-1 W^T
    if use_dense:
        # the reduced-system RECOVERY runs in f64 ON THE HOST — the
        # reference's MarginalCovarianceCholesky is double-precision
        # throughout (marginal_covariance_cholesky.h:50-103), and f32
        # recovery leaves ~1e-2 relative block error (the 3e4-term f32
        # S-correction contractions leave dS/S ~ 1e-5 that the
        # ~1e3-conditioned inverse amplifies). The heavy O(E) work —
        # linearize, the W/Hll/Hcc products — already ran on the device in
        # ONE jitted program; what moves here is the [L, K, Dp, dl] W table
        # (5.8 MB at the 80k bench shape, against 72 MB for the dense
        # [Tp, dl*L] B2, so the one-hot densify re-runs on the host in f64)
        # plus ~40 GFLOP of dgemm on a [Tp, Tp] system. The H100 computes
        # f64 natively; moving this tail onto the device is ROADMAP Speed
        # item 6.
        B2r = np.zeros((Tp, dl, L))
        for pd in sys["proj"]:
            pgp = pd["pg"]
            off, Dp_g = cam_offsets(pgp)
            W_np = np.asarray(_gather_w_flat(problem, lin, pgp),
                              dtype=np.float64)         # [L, K, Dp, dl]
            lm_cam = np.asarray(pgp.lm_cam)
            acc = np.zeros((problem.static.vgroup(pgp.cam_group).count,
                            L, Dp_g, dl))
            ls = np.arange(L)
            for k in range(lm_cam.shape[1]):
                np.add.at(acc, (lm_cam[:, k], ls), W_np[:, k])
            B2r[off:off + acc.shape[0] * Dp_g] += np.moveaxis(
                acc, 1, -1).reshape(-1, dl, L)
        # landmark-block inverses ALSO in host f64: the f32 closed-form
        # _inv_lane loses ~cond(Hll_j)*eps digits on poorly-conditioned
        # landmark blocks, and every such error poisons S globally through
        # the W Hinv W^T correction
        Hll_np = np.moveaxis(np.asarray(Hll_d_lane, dtype=np.float64),
                             -1, 0)                     # [L, dl, dl]
        Hinv_np = np.linalg.inv(Hll_np)
        HB2 = np.einsum("ctl,utl->cul", B2r,
                        np.moveaxis(Hinv_np, 0, -1)).reshape(Tp, dl * L)
        B2f = B2r.reshape(Tp, dl * L)
        S_corr = B2f @ HB2.T
        S_np = np.asarray(S, dtype=np.float64) - 0.5 * (S_corr + S_corr.T)
        dsc = np.sqrt(np.clip(np.diag(S_np), 1e-300, None))
        Ss = S_np / dsc[:, None] / dsc[None, :]
        Lchol = np.linalg.cholesky(Ss)
        Li = np.linalg.inv(Lchol)
        Sinv_np = (Li.T @ Li) / dsc[:, None] / dsc[None, :]
        # landmark back-substitution correction, same precision
        M = (Sinv_np @ B2f).reshape(Tp, dl, L)
        corr = np.einsum("ctl,cul->ltu", B2r, M)
        cov_l64 = Hinv_np + np.einsum("lst,ltu,luv->lsv", Hinv_np, corr,
                                      Hinv_np)
        Sinv = jnp.asarray(Sinv_np, dtype=dt)
        cov_l_dense = jnp.asarray(cov_l64, dtype=dt)
    else:
        # tiled landmark-major neighbor pairs (beyond-gate shapes)
        for pd in sys["proj"]:
            pg = pd["pg"]
            off, Dp = cam_offsets(pg)
            W_lm = _gather_w_flat(problem, lin, pg)      # [L, K, Dp, dl]
            K = W_lm.shape[1]
            for (a0, a1) in _pair_tiles(K):
                Wa = jnp.einsum("lkst,ltu->lksu", W_lm[:, a0:a1], Hinv)
                ca = pg.lm_cam[:, a0:a1]
                for (b0, b1) in _pair_tiles(K):
                    T = jnp.einsum("lksu,lmvu->lkmsv", Wa, W_lm[:, b0:b1])
                    cb = pg.lm_cam[:, b0:b1]
                    rows = (off + ca[:, :, None] * Dp)[..., None, None] \
                        + jnp.arange(Dp)[None, None, None, :, None]
                    cols = (off + cb[:, None, :] * Dp)[..., None, None] \
                        + jnp.arange(Dp)[None, None, None, None, :]
                    S = S.at[rows, cols].add(-T)

    # ---- Cov_pp = S^-1 ---------------------------------------------------
    if not use_dense:
        # f32 path for beyond-gate shapes, with Jacobi equilibration:
        # scaling by d = sqrt(diag(S)) makes the factored matrix
        # unit-diagonal (cond drops by the scale spread squared); the
        # inverse unscales exactly.
        d = jnp.sqrt(jnp.clip(jnp.diag(S), 1e-30, None))
        Ss = S / d[:, None] / d[None, :]
        Lchol = jnp.linalg.cholesky(Ss)
        Sinv_s = solve_triangular(
            Lchol.T, solve_triangular(Lchol, jnp.eye(Tp, dtype=dt),
                                      lower=True), lower=False)
        Sinv = Sinv_s / d[:, None] / d[None, :]

    out = {}
    for g in pose_groups:
        D = g.tangent_dim
        gidx = (g.offset + jnp.arange(g.count)[:, None] * D
                + jnp.arange(D)[None, :])
        f = problem.free[g.name]
        out[g.name] = Sinv[gidx[:, :, None], gidx[:, None, :]] \
            * f[:, None, None]

    # ---- Cov_ll diagonal via back-substitution ---------------------------
    if use_dense:
        # computed in the f64 scope above (corr_l = (B^T S^-1 B) landmark
        # blocks via one matmul M = S^-1 B — B's column block for
        # landmark l is nonzero exactly at its observing cameras, so the
        # dense contraction equals the neighbor-pair sum)
        cov_l = cov_l_dense
    else:
        corr = jnp.zeros((L, dl, dl), dtype=dt)
        for pd in sys["proj"]:
            pg = pd["pg"]
            off, Dp = cam_offsets(pg)
            W_lm = _gather_w_flat(problem, lin, pg)
            K = W_lm.shape[1]
            for (a0, a1) in _pair_tiles(K):
                ca = pg.lm_cam[:, a0:a1]
                for (b0, b1) in _pair_tiles(K):
                    cb = pg.lm_cam[:, b0:b1]
                    rows = (off + ca[:, :, None] * Dp)[..., None, None] \
                        + jnp.arange(Dp)[None, None, None, :, None]
                    cols = (off + cb[:, None, :] * Dp)[..., None, None] \
                        + jnp.arange(Dp)[None, None, None, None, :]
                    cov_blk = Sinv[rows, cols]         # [L, ka, kb, Dp, Dp]
                    corr = corr + jnp.einsum(
                        "lkst,lkmsv,lmvu->ltu",
                        W_lm[:, a0:a1], cov_blk, W_lm[:, b0:b1])
        cov_l = Hinv + jnp.einsum("lst,ltu,luv->lsv", Hinv, corr, Hinv)
    out[pattern.lm_name] = cov_l * free_l[:, None, None]
    return out


def _gather_w_flat(problem: Problem, lin: dict, pg):
    """[L, K_l, Dp, dl] landmark-major coupling blocks W = Jc^T W_omega Jl,
    masked on padding slots (the ba_ell W_lm layout, flat form).

    EXPLICIT HIGHEST precision on the einsum: _build computes the same W
    through elementwise products (exact f32); this batched-tiny-matmul
    form must match it, and at the default precision the batched dot may
    run in reduced precision (TF32 on the GPU) — a ~1e-3 rounding of W
    that alone would exceed the marginals spot-check gate."""
    ea = problem.edges[pg.egkey]
    resid, jacs, w = lin[pg.egkey]
    w_omega = w[:, None, None] * ea.information
    Jl, Jc = jacs[pg.lm_slot], jacs[pg.cam_slot]
    W = jnp.einsum("eas,eab,ebt->est", Jc, w_omega, Jl,
                   precision=jax.lax.Precision.HIGHEST)   # [E, Dp, dl]
    return W[pg.lm_edge_idx] * pg.lm_mask[:, :, None, None]


def compute_marginals_all_diagonal(problem: Problem):
    """All per-vertex diagonal covariance blocks, as {group: [N, D, D]}.

    The bulk variant used for visualization (covariance ellipses in the
    viewer) — one full dense inverse via Cholesky, then block-diagonal
    extraction; on the device this is a single dense solve.
    """
    H, _, _ = build_dense_system(problem)
    L = jnp.linalg.cholesky(H)
    T = problem.static.total_dim
    inv = solve_triangular(
        L.T, solve_triangular(L, jnp.eye(T, dtype=problem.dtype), lower=True),
        lower=False)
    free_t, _ = tangent_masks(problem)
    inv = inv * free_t[:, None] * free_t[None, :]
    out = {}
    for g in problem.static.vgroups:
        D = g.tangent_dim
        gidx = (g.offset + jnp.arange(g.count)[:, None] * D
                + jnp.arange(D)[None, :])
        out[g.name] = inv[gidx[:, :, None], gidx[:, None, :]]
    return out
