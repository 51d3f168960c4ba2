"""Scatter-free bundle adjustment: dual-ELL Schur solver, lane-major.

The general Schur path (core/ba.py) accumulates with segment_sums, which
lower to scatter-adds inside the PCG hot loop.
This module removes every scatter from the iteration for the canonical BA
shape (binary projection edges: one landmark slot + one pose slot; optional
pose-pose edges):

* observations live in TWO neighbor-padded ELL index tables, by-landmark
  ``[L, K_l]`` and by-camera ``[C, K_c]`` (host-precomputed per topology),
* every reduction — Hll blocks, b_l, Hcc diagonal blocks, b_p, the
  W^T x / W v products inside PCG, the preconditioner correction — is a
  gather + masked multiply-reduce over the K axis.

Layout rule (the same one as the pose-graph matvec, core/sparse.py): keep
the OWNER axis (L landmarks / C cameras) on the minor axis of every array
the hot loop touches, with the tiny block dims (Dp=6, dl=3) leading.
Concretely:

* per-edge streams are ``[D, E]`` (edge on lanes),
* the pre-gathered W coupling tables are ``[Dp*dl, K, N]`` (owner
  minor, K next) — an ``[N, K, Dp, dl]`` form puts the 6/3-sized dims on
  the minor axes, where tiled layouts pad them,
* every vector in the PCG loop is a ``[D, N]`` lane-major part; gathers
  are ``jnp.take`` along lanes with ``[K, N]`` k-major index tables,
* block inverses/products on ``[D, D, N]`` stacks are closed-form
  elementwise arithmetic (``_inv_lane``/``_bmv_lane``).

K-axis chunking: gather programs over a huge K axis are lax.scan-ned in
``_K_CHUNK``-sized chunks to bound XLA program size and intermediate
footprints at BAL scale.

Reference parity: the Schur-complement reduction and back-substitution
follow block_solver.hpp:353-486 (schurComplement / solve's landmark
back-substitution); LM trial semantics per
optimization_algorithm_levenberg.cpp:95-142.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from openslam_g2o_tpu.core.problem import (
    Problem, linearize, robust_chi2, _slot_tangent_indices)
from openslam_g2o_tpu.core.solvers import pcg_solve

__all__ = ["build_ba_ell_pattern", "BAEllPattern", "_lm_ba_ell_step",
           "ba_ell_step", "ba_ell_optimize_fused", "dense_schur_ok",
           "LevenbergMarquardtSchurELL"]


@partial(jax.tree_util.register_dataclass,
         data_fields=["lm_edge_idx", "lm_mask", "cam_edge_idx", "cam_mask",
                      "li", "ci", "lm_cam", "cam_lm", "lm_cam_onehot",
                      "cam_onehot", "lm_buckets", "cam_buckets", "lm_perm",
                      "cam_perm"],
         meta_fields=["egkey", "lm_slot", "cam_slot", "cam_group", "lm_group"])
@dataclasses.dataclass
class ProjGroupPattern:
    """Dual-ELL tables for one projection edge group.

    lm_buckets / cam_buckets: degree-bucketed (sliced-ELL) owner tables —
    tuples of (rows, eidxT, maskT, nbT) buckets, host-built. A uniform
    K = max-degree table wastes gather throughput on padding when degrees
    are skewed (the 400k-obs synthetic BAL has mean 444 observations per
    camera but max 1768 — 4.6x padded work per matvec); each bucket
    instead holds the owners whose degree falls in one power-of-two range,
    with K_b its own ceiling. rows is None for an all-owners bucket;
    eidxT/maskT index the per-edge stream; nbT holds the OTHER side's
    vertex ids for the matvec gathers. Tables are [K_b, C_b], or chunked
    [nch, _K_CHUNK, C_b] when K_b is large (XLA program-size bound)."""
    lm_edge_idx: jnp.ndarray    # [L, K_l] int32 edge ids (0-padded)
    lm_mask: jnp.ndarray        # [L, K_l] 1.0 valid / 0.0 pad
    cam_edge_idx: jnp.ndarray   # [C, K_c]
    cam_mask: jnp.ndarray       # [C, K_c]
    li: jnp.ndarray             # [E] landmark index per edge
    ci: jnp.ndarray             # [E] camera index per edge
    lm_cam: jnp.ndarray         # [L, K_l] camera of each landmark slot
    cam_lm: jnp.ndarray         # [C, K_c] landmark of each camera slot
    lm_cam_onehot: jnp.ndarray  # [C, K_l, L] {0,1} or None — dense-Schur
    cam_onehot: jnp.ndarray     # [E, C] {0,1} or None — matmul owner-reduce
    lm_buckets: tuple           # densify operand (see _DENSE_SCHUR gates)
    cam_buckets: tuple
    lm_perm: jnp.ndarray        # [L]/[C] int32 owner -> concat position,
    cam_perm: jnp.ndarray       # or None for a single all-owners bucket
    egkey: str
    lm_slot: int
    cam_slot: int
    cam_group: str
    lm_group: str


@partial(jax.tree_util.register_dataclass,
         data_fields=["proj", ], meta_fields=["pose_only_keys", "lm_name"])
@dataclasses.dataclass
class BAEllPattern:
    proj: tuple                  # ProjGroupPattern per projection group
    pose_only_keys: tuple        # edge group keys without a landmark slot
    lm_name: str


def _ell_tables(owner_idx: np.ndarray, n_owners: int):
    """[E] owner ids -> ([n_owners, K] edge-id table, mask)."""
    E = len(owner_idx)
    order = np.argsort(owner_idx, kind="stable")
    counts = np.bincount(owner_idx, minlength=n_owners)
    K = max(int(counts.max()) if E else 1, 1)
    tbl = np.zeros((n_owners, K), dtype=np.int32)
    mask = np.zeros((n_owners, K), dtype=np.float64)
    starts = np.zeros(n_owners + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for o in range(n_owners):
        seg = order[starts[o]:starts[o + 1]]
        tbl[o, :len(seg)] = seg
        mask[o, :len(seg)] = 1.0
    return tbl, mask


# Smallest bucket boundary of the sliced-ELL split: below this the padding
# waste cannot exceed 64x the useful work on a handful of rows — not worth
# extra program segments.
_BUCKET_MIN = 64

# Multi-bucket (sliced-ELL) tables are OFF until the benchmark shows they
# pay on the H100. Correctness is checked: forced-small configurations in
# the tests, and scripts/canary_bucketed_400k.py, whose CPU and GPU chi2
# trajectories at the 400k bench shape agree on the H100.
_BUCKET_ENABLE = False

# Buckets with fewer owner rows than this merge into the next degree range
# (sub-tile owner counts would create narrow-lane kernels for marginal
# savings).
_BUCKET_MIN_ROWS = 32

# Single-table short-circuit: bucketing only pays when the uniform table's
# padded slots exceed this fraction of the real work.
_BUCKET_WASTE = 1.3


def _bucketize(tbl: np.ndarray, mask: np.ndarray, nb_ids: np.ndarray,
               dtype) -> tuple:
    """Host: degree-bucketed owner tables (ProjGroupPattern bucket format).

    tbl/mask [N, K] edge-id ELL; nb_ids [N, K] the other-side vertex id of
    each slot. Single all-rows bucket when padding waste is <30% or K is
    small; otherwise one bucket per power-of-two degree range.

    Returns (buckets, perm): perm is None for the single all-rows bucket,
    else an [N] int32 map from owner id to its position in the
    CONCATENATED per-bucket output stream (with one trailing zero slot for
    degree-0 owners) — bucket results are placed by ONE lane gather, never
    a scatter."""
    N, K = tbl.shape
    counts = mask.sum(axis=1).astype(np.int64)

    def pack(rows, kb, chunk_limit=None):
        if rows is None:
            st, sm, sn = tbl[:, :kb], mask[:, :kb], nb_ids[:, :kb]
        else:
            st = tbl[rows][:, :kb]
            sm = mask[rows][:, :kb]
            sn = nb_ids[rows][:, :kb]
        eidxT = np.ascontiguousarray(st.T)
        maskT = np.ascontiguousarray(sm.T)
        nbT = np.ascontiguousarray(sn.T)
        # bucketed tables avoid in-bucket scans up to 4*_K_CHUNK (flat
        # K-major gathers compile fine well past the old blowup point);
        # the single-table path keeps the proven 2*_K_CHUNK threshold
        if chunk_limit is None:
            chunk_limit = 4 * _K_CHUNK
        if kb > chunk_limit:
            nch = -(-kb // _K_CHUNK)
            pad = nch * _K_CHUNK - kb
            if pad:
                eidxT = np.pad(eidxT, [(0, pad), (0, 0)])
                maskT = np.pad(maskT, [(0, pad), (0, 0)])
                nbT = np.pad(nbT, [(0, pad), (0, 0)])
            cb = eidxT.shape[1]
            eidxT = eidxT.reshape(nch, _K_CHUNK, cb)
            maskT = maskT.reshape(nch, _K_CHUNK, cb)
            nbT = nbT.reshape(nch, _K_CHUNK, cb)
        return (None if rows is None else jnp.asarray(
                    rows.astype(np.int32)),
                jnp.asarray(eidxT.astype(np.int32)),
                jnp.asarray(maskT, dtype=dtype),
                jnp.asarray(nbT.astype(np.int32)))

    total = max(int(counts.sum()), 1)
    if (not _BUCKET_ENABLE or K <= _BUCKET_MIN
            or N * K <= _BUCKET_WASTE * total):
        return (pack(None, K, chunk_limit=2 * _K_CHUNK),), None
    bounds = [0]
    b = _BUCKET_MIN
    while b < K:
        bounds.append(b)
        b *= 2
    bounds.append(K)
    ranges = []
    for lo, hi in zip(bounds, bounds[1:]):
        rows = np.nonzero((counts > max(lo, 0)) & (counts <= hi)
                          & (counts > 0))[0]
        if len(rows):
            ranges.append([rows, hi])
    # merge skinny buckets into the next degree range: sub-tile owner
    # counts would create narrow-lane kernels for marginal savings
    merged = []
    for rows, hi in ranges:
        if merged and len(merged[-1][0]) < _BUCKET_MIN_ROWS:
            merged[-1] = [np.concatenate([merged[-1][0], rows]), hi]
        else:
            merged.append([rows, hi])
    if len(merged) >= 2 and len(merged[-1][0]) < _BUCKET_MIN_ROWS:
        last_rows, last_hi = merged.pop()
        merged[-1] = [np.concatenate([merged[-1][0], last_rows]), last_hi]
    if len(merged) <= 1:
        return (pack(None, K, chunk_limit=2 * _K_CHUNK),), None
    out = []
    perm = np.full(N, -1, dtype=np.int64)
    off = 0
    for rows, hi in merged:
        perm[rows] = off + np.arange(len(rows))
        off += len(rows)
        out.append(pack(rows, hi))
    perm[perm < 0] = off          # degree-0 owners read the zero slot
    return tuple(out), jnp.asarray(perm.astype(np.int32))


# Dense-Schur routing gates: the reduced camera system is formed DENSELY
# and solved by one dense Cholesky when the pose tangent block is small
# enough. Rationale: the implicit Schur matvec pays ~2*E gathers per PCG
# iteration, while the dense route turns the W products into matmuls and
# the solve into one [Tp, Tp] factorization. Above the gates (big camera
# counts) the dense product's (3L)*(Tp^2) FLOPs and its [Tp, 3L] operand
# blow up and the implicit matrix-free PCG path takes over. Both routes are
# exact on any backend; the thresholds were sized for a 16 GB device and
# are not yet re-derived for the H100's 80 GB (ROADMAP, Speed item 2).
_DENSE_SCHUR_MAX_TP = 1536
_DENSE_SCHUR_MAX_OPERAND_BYTES = 3e8


def dense_schur_ok(problem, pattern) -> bool:
    """Single source of truth for the dense-Schur routing predicate: the
    solver (_build) and the roofline cost model (utils/roofline
    .ba_ell_step_cost) must agree on which branch runs, including the
    single-flat-bucket conditions the bucketed tables would violate."""
    lg = problem.static.vgroup(pattern.lm_name)
    L, dl = lg.count, lg.tangent_dim
    Tp = problem.static.pose_dim
    itemsize = np.dtype(problem.dtype).itemsize
    return bool(
        Tp <= _DENSE_SCHUR_MAX_TP
        and pattern.proj
        and all(pg.lm_cam_onehot is not None
                and len(pg.lm_buckets) == 1
                and pg.lm_buckets[0][0] is None
                and pg.lm_buckets[0][1].ndim == 2
                for pg in pattern.proj)
        and Tp * dl * L * itemsize <= _DENSE_SCHUR_MAX_OPERAND_BYTES)


def build_ba_ell_pattern(problem: Problem) -> BAEllPattern:
    """Host symbolic phase. Requires: every edge group with a marginalized
    slot is binary (landmark, pose)."""
    mg = problem.static.marginalized_groups
    if len(mg) != 1:
        raise ValueError("dual-ELL Schur expects exactly one marginalized group")
    lg = mg[0]

    proj = []
    pose_only = []
    for eg in problem.static.egroups:
        slot_groups = [problem.static.vgroup(g) for g in eg.slots]
        lm_slots = [s for s in range(len(slot_groups))
                    if slot_groups[s].name == lg.name]
        if not lm_slots:
            pose_only.append(eg.key)
            continue
        if len(lm_slots) != 1 or eg.etype.num_vertices != 2:
            raise ValueError(
                f"edge group {eg.key} is not a binary (landmark, pose) "
                f"projection edge; use the general Schur solver")
        sl = lm_slots[0]
        sc = 1 - sl
        ea = problem.edges[eg.key]
        li = np.asarray(ea.indices[sl])
        ci = np.asarray(ea.indices[sc])
        lm_tbl, lm_mask = _ell_tables(li, lg.count)
        cam_tbl, cam_mask = _ell_tables(ci, slot_groups[sc].count)
        dt = problem.dtype
        # dense-Schur densify operand (see gate rationale above): a {0,1}
        # tensor oh[c, k, l] selecting, for landmark l's k-th observation,
        # its camera column — turns the W densification into one einsum
        C = slot_groups[sc].count
        L, K_l = lm_tbl.shape
        itemsize = np.dtype(problem.dtype).itemsize
        onehot = None
        if (C * K_l * L * itemsize <= _DENSE_SCHUR_MAX_OPERAND_BYTES
                and K_l <= 2 * _K_CHUNK):
            oh = np.zeros((C, K_l, L), dtype=np.float32)
            kk, ll = np.meshgrid(np.arange(K_l), np.arange(L), indexing="ij")
            oh[ci[lm_tbl].T, kk, ll] = lm_mask.T
            onehot = jnp.asarray(oh, dtype=dt)
        # camera-side owner-reduce selector [E, C]: turns the Hcc/b_p
        # owner sums into ONE matmul ([D*D, E] @ [E, C]) instead of
        # E*K_c*D*D gathered elements. Gated by operand size (the 400k
        # shape would need a 1.4 GB selector).
        cam_oh = None
        E_g = len(ci)
        if E_g * C * itemsize <= _DENSE_SCHUR_MAX_OPERAND_BYTES:
            coh = np.zeros((E_g, C), dtype=np.float32)
            coh[np.arange(E_g), ci] = 1.0
            cam_oh = jnp.asarray(coh, dtype=dt)
        proj.append(ProjGroupPattern(
            jnp.asarray(lm_tbl), jnp.asarray(lm_mask, dtype=dt),
            jnp.asarray(cam_tbl), jnp.asarray(cam_mask, dtype=dt),
            jnp.asarray(li.astype(np.int32)), jnp.asarray(ci.astype(np.int32)),
            jnp.asarray(ci[lm_tbl].astype(np.int32)),
            jnp.asarray(li[cam_tbl].astype(np.int32)),
            onehot, cam_oh,
            *(lambda lb, cb: (lb[0], cb[0], lb[1], cb[1]))(
                _bucketize(lm_tbl, lm_mask, ci[lm_tbl], dt),
                _bucketize(cam_tbl, cam_mask, li[cam_tbl], dt)),
            eg.key, sl, sc, slot_groups[sc].name, lg.name))
    return BAEllPattern(tuple(proj), tuple(pose_only), lg.name)


# K-axis chunking bound: a large-K table is a tall [D, K, N] array, and
# packing the whole axis into one gather/contract program blows up compile
# time and intermediate footprints at BAL scale. Chunks of 512 keep
# programs one-chunk-sized at identical FLOPs. The value was tuned for the
# previous accelerator's compiler and is not yet re-tuned for the H100.
_K_CHUNK = 512


# -- lane-major small-matrix helpers ([D, D, N] stacks, [D, N] vectors) ------

def _bmv_lane(A, x):
    """y[a, n] = sum_b A[a, b, n] x[b, n]."""
    return (A * x[None]).sum(axis=1)


def _bmv_lane_t(A, x):
    """y[b, n] = sum_a A[a, b, n] x[a, n]  (A^T x)."""
    return (A * x[:, None]).sum(axis=0)


def _diag_lane(A):
    """[D, D, N] -> [D, N] diagonal."""
    D = A.shape[0]
    return jnp.stack([A[i, i] for i in range(D)])


def _eye_lane(D, dtype):
    return jnp.eye(D, dtype=dtype)[:, :, None]


def _bmm_lane(A, B):
    """C[a, c, n] = sum_b A[a, b, n] B[b, c, n] — lane-major small matmul."""
    return (A[:, :, None] * B[None]).sum(axis=1)


def _inv_lane(A):
    """Inverse of a [D, D, N] stack of small SPD matrices, elementwise on
    N-minor arrays: closed-form adjugate for D <= 3, recursive 2x2-block
    Schur inversion above (D=6 camera blocks split into 3x3 quadrants) —
    elementwise work that fuses, instead of jnp.linalg.inv's batched LU on
    tiny matrices."""
    D = A.shape[0]
    if D == 1:
        return 1.0 / A
    if D == 2:
        a, b = A[0, 0], A[0, 1]
        c, d = A[1, 0], A[1, 1]
        inv_det = 1.0 / (a * d - b * c)
        row0 = jnp.stack([d, -b])
        row1 = jnp.stack([-c, a])
        return jnp.stack([row0, row1]) * inv_det[None, None]
    if D == 3:
        a, b, c = A[0, 0], A[0, 1], A[0, 2]
        d, e, f = A[1, 0], A[1, 1], A[1, 2]
        g, h, i = A[2, 0], A[2, 1], A[2, 2]
        A11 = e * i - f * h; A12 = c * h - b * i; A13 = b * f - c * e
        A21 = f * g - d * i; A22 = a * i - c * g; A23 = c * d - a * f
        A31 = d * h - e * g; A32 = b * g - a * h; A33 = a * e - b * d
        inv_det = 1.0 / (a * A11 + b * A21 + c * A31)
        adj = jnp.stack([jnp.stack([A11, A12, A13]),
                         jnp.stack([A21, A22, A23]),
                         jnp.stack([A31, A32, A33])])
        return adj * inv_det[None, None]
    # blockwise Schur inversion: A = [[P, Q], [R, S]], SPD
    k = D // 2
    P, Q = A[:k, :k], A[:k, k:]
    R, S = A[k:, :k], A[k:, k:]
    Pi = _inv_lane(P)
    PiQ = _bmm_lane(Pi, Q)
    Ti = _inv_lane(S - _bmm_lane(R, PiQ))
    RPi = _bmm_lane(R, Pi)
    TiRPi = _bmm_lane(Ti, RPi)
    return jnp.concatenate([
        jnp.concatenate([Pi + _bmm_lane(PiQ, TiRPi),
                         -_bmm_lane(PiQ, Ti)], axis=1),
        jnp.concatenate([-TiRPi, Ti], axis=1)], axis=0)


# -- bucketed K-major table consumers ---------------------------------------
#
# Buckets come from _bucketize (host): per bucket, index/mask/nb tables are
# [K_b, C_b] flat or [nch, _K_CHUNK, C_b] chunked (ndim tells which); rows
# is None for an all-owners bucket, else the owner ids whose outputs the
# bucket produces (disjoint across buckets -> scatter-SET into zeros).

def _bucket_scan(one, eidxT, maskT, init):
    def body(acc, inp):
        return acc + one(*inp), None
    out, _ = jax.lax.scan(body, init, (eidxT, maskT))
    return out


def _place(parts, perm, lead_shape, dtype):
    """Place per-bucket results [*lead, C_b] into the owner order: a
    concat + ONE lane gather through the host-built inverse permutation
    (perm None = single all-owners bucket, direct). Never a scatter."""
    if perm is None:
        return parts[0]
    cat = jnp.concatenate(
        list(parts) + [jnp.zeros(tuple(lead_shape) + (1,), dtype)], axis=-1)
    return jnp.take(cat, perm, axis=-1)


def _reduce_k_lane(streamT, buckets, perm, n_out):
    """Owner-sum of a per-edge lane-major stream: [D, E] -> [D, n_out]."""
    D = streamT.shape[0]

    def one(ic, mc):
        cb = ic.shape[-1]
        g = jnp.take(streamT, ic.reshape(-1), axis=1).reshape(D, -1, cb)
        return (g * mc[None]).sum(axis=1)

    parts = []
    for rows, eidxT, maskT, _ in buckets:
        if eidxT.ndim == 2:
            parts.append(one(eidxT, maskT))
        else:
            parts.append(_bucket_scan(one, eidxT, maskT, jnp.zeros(
                (D, eidxT.shape[-1]), dtype=streamT.dtype)))
    return _place(parts, perm, (D,), streamT.dtype)


def _gather_w_lane(streamT, buckets):
    """Pre-gather the per-edge W stream [D, E] into per-bucket owner
    layouts: list of [D, K_b, C_b] (or [nch, D, chunk, C_b] chunked), with
    padding slots zeroed by the mask."""
    D = streamT.shape[0]
    out = []
    for rows, eidxT, maskT, _ in buckets:
        if eidxT.ndim == 2:
            W = jnp.take(streamT, eidxT.reshape(-1), axis=1).reshape(
                D, *eidxT.shape) * maskT[None]
        else:
            W = jax.lax.map(
                lambda im: jnp.take(streamT, im[0].reshape(-1), axis=1)
                .reshape(D, *im[0].shape) * im[1][None], (eidxT, maskT))
        out.append(W)
    return out


def _apply_w_lane(W_list, buckets, perm, xT, Dp, dl, to_lm: bool,
                  n_out: int):
    """The Schur coupling products, owner on lanes, bucket by bucket.

    to_lm:  u[t, L] = sum_{k, s} W[s, t, k, L] * x[s, cam_of(k, L)]
            (W^T x: camera vector -> landmark space)
    else:   y[s, C] = sum_{k, t} W[s, t, k, C] * v[t, lm_of(k, C)]
            (W v: landmark vector -> camera space)
    """
    Dx = Dp if to_lm else dl
    D_out = dl if to_lm else Dp
    dt = W_list[0].dtype

    def one(Wc, ic):
        cb = ic.shape[-1]
        W4 = Wc.reshape(Dp, dl, -1, cb)
        xg = jnp.take(xT, ic.reshape(-1), axis=1).reshape(Dx, -1, cb)
        if to_lm:
            return (W4 * xg[:, None]).sum(axis=(0, 2))
        return (W4 * xg[None]).sum(axis=(1, 2))

    parts = []
    for W, (rows, eidxT, _, nbT) in zip(W_list, buckets):
        if eidxT.ndim == 2:
            parts.append(one(W, nbT))
        else:
            parts.append(_bucket_scan(one, W, nbT, jnp.zeros(
                (D_out, nbT.shape[-1]), dtype=dt)))
    return _place(parts, perm, (D_out,), dt)


def _sandwich_lane(W_list, buckets, perm, M_lane, Dp, dl, n_out: int):
    """corr[s, v, C] = sum_k (W_k M_{lm(k)} W_k^T)[s, v] — the block-Jacobi
    preconditioner correction on the reduced camera system, bucketed like
    _apply_w_lane. M_lane: [dl, dl, L]."""
    Mflat = M_lane.reshape(dl * dl, -1)
    dt = W_list[0].dtype

    def one(Wc, ic):
        cb = ic.shape[-1]
        W4 = Wc.reshape(Dp, dl, -1, cb)
        Mg = jnp.take(Mflat, ic.reshape(-1), axis=1).reshape(dl, dl, -1, cb)
        tmp = (W4[:, :, None] * Mg[None]).sum(axis=1)    # [Dp, dl, k, cb]
        return (tmp[:, None] * W4[None]).sum(axis=(2, 3))

    parts = []
    for W, (rows, eidxT, _, nbT) in zip(W_list, buckets):
        if eidxT.ndim == 2:
            parts.append(one(W, nbT))
        else:
            parts.append(_bucket_scan(one, W, nbT, jnp.zeros(
                (Dp, Dp, nbT.shape[-1]), dtype=dt)))
    return _place(parts, perm, (Dp, Dp), dt)


def _build(problem: Problem, pattern: BAEllPattern, lin: dict):
    """Per-linearization quantities, all lane-major and scatter-free except
    the (small) pose-pose extra.

    Per-edge products run edge-on-lanes: each J^T W J / W-coupling block is
    an elementwise multiply + tiny-axis reduce over [*, *, E] streams (one
    moveaxis per jacobian at entry; everything downstream stays dense on
    the (8, 128) tiles)."""
    dt = problem.dtype
    lg = problem.static.vgroup(pattern.lm_name)
    L, dl = lg.count, lg.tangent_dim
    Tp = problem.static.pose_dim
    dense_ok = dense_schur_ok(problem, pattern)

    Hll = jnp.zeros((dl, dl, L), dtype=dt)               # lane-major
    b_l = jnp.zeros((dl, L), dtype=dt)
    groups = {}   # cam group name -> dict with Hcc (lane), bT parts

    proj_data = []
    for pg in pattern.proj:
        ea = problem.edges[pg.egkey]
        resid, jacs, w = lin[pg.egkey]
        # edge-on-lanes streams
        residT = resid.T                                  # [r, E]
        JlT = jnp.moveaxis(jacs[pg.lm_slot], 0, -1)       # [r, dl, E]
        JcT = jnp.moveaxis(jacs[pg.cam_slot], 0, -1)      # [r, Dp, E]
        w_omegaT = w[None, None, :] * jnp.moveaxis(ea.information, 0, -1)
        Dp = JcT.shape[1]
        # Jl_w[s, b, E] = sum_a Jl[a, s, E] w_omega[a, b, E]
        Jl_wT = (JlT[:, :, None] * w_omegaT[:, None]).sum(axis=0)
        Jc_wT = (JcT[:, :, None] * w_omegaT[:, None]).sum(axis=0)
        # Hll_e[s, t, E] = sum_b Jl_w[s, b, E] Jl[b, t, E]
        Hll_e = (Jl_wT[:, :, None] * JlT[None]).sum(axis=1)
        bl_e = -(Jl_wT * residT[None]).sum(axis=1)        # [dl, E]
        Hll = Hll + _reduce_k_lane(Hll_e.reshape(dl * dl, -1),
                                   pg.lm_buckets, pg.lm_perm, L).reshape(dl, dl, L)
        b_l = b_l + _reduce_k_lane(bl_e, pg.lm_buckets, pg.lm_perm, L)
        W_T = (Jc_wT[:, :, None] * JlT[None]).sum(axis=1)  # [Dp, dl, E]
        Hcc_e = (Jc_wT[:, :, None] * JcT[None]).sum(axis=1)
        bp_e = -(Jc_wT * residT[None]).sum(axis=1)        # [Dp, E]
        cg = problem.static.vgroup(pg.cam_group)
        C = cg.count
        slot = groups.setdefault(pg.cam_group, {
            "Hcc": jnp.zeros((cg.tangent_dim, cg.tangent_dim, C), dt),
            "bT": jnp.zeros((cg.tangent_dim, C), dt)})
        if pg.cam_onehot is not None:
            # camera-side owner sums as ONE matmul over the edge axis (the
            # [E, C] selector) — replaces Dp*Dp*E + Dp*E gathered elements
            # with a 2*(Dp*Dp+Dp)*E*C-FLOP matmul
            # NOTE precision: both reduces run HIGHEST. At the default
            # precision a float32 matmul runs in TF32 on the H100, which
            # rounds every per-edge Hcc block to a 10-bit mantissa; the
            # Schur complement's cancellation then carried that into a
            # >1e-3 error of the exact dense-Schur step (chip_smoke
            # schur_step_exact). Both are [*, E] @ [E, C] matmuls of
            # negligible cost. The gradient reduce steers every consumer,
            # damped or not.
            red = jnp.matmul(Hcc_e.reshape(Dp * Dp, -1), pg.cam_onehot,
                             precision=jax.lax.Precision.HIGHEST)
            red_b = jnp.matmul(bp_e, pg.cam_onehot,
                               precision=jax.lax.Precision.HIGHEST)
            slot["Hcc"] = slot["Hcc"] + red.reshape(Dp, Dp, C)
            slot["bT"] = slot["bT"] + red_b
        else:
            slot["Hcc"] = slot["Hcc"] + _reduce_k_lane(
                Hcc_e.reshape(Dp * Dp, -1), pg.cam_buckets, pg.cam_perm,
                C).reshape(Dp, Dp, C)
            slot["bT"] = slot["bT"] + _reduce_k_lane(
                bp_e, pg.cam_buckets, pg.cam_perm, C)
        # pre-gather W into the bucketed ELL layouts (one-time per
        # linearization) so PCG matvecs gather only from the small [D, N]
        # vector tables. The camera-side table is ONLY consumed by the
        # implicit-PCG solve branch — on the dense-Schur route every W
        # product runs through B2, so the gather is skipped entirely.
        W_stream = W_T.reshape(Dp * dl, -1)
        proj_data.append({
            "pg": pg,
            "W_lm": _gather_w_lane(W_stream, pg.lm_buckets),
            "W_cam": (None if dense_ok
                      else _gather_w_lane(W_stream, pg.cam_buckets)),
            "Dp": Dp})

    # pose-only edges -> small dense extra over the pose tangent block
    Hpp_extra = jnp.zeros((Tp, Tp), dtype=dt)
    b_extra = jnp.zeros((Tp,), dtype=dt)
    for key in pattern.pose_only_keys:
        eg = next(e for e in problem.static.egroups if e.key == key)
        ea = problem.edges[key]
        resid, jacs, w = lin[key]
        w_omega = w[:, None, None] * ea.information
        k = eg.etype.num_vertices
        slot_groups = [problem.static.vgroup(g) for g in eg.slots]
        idx = [_slot_tangent_indices(slot_groups[s], ea.indices[s])
               for s in range(k)]
        for s in range(k):
            js_w = jnp.einsum("eas,eab->esb", jacs[s], w_omega)
            b_extra = b_extra.at[idx[s]].add(
                -jnp.einsum("esb,eb->es", js_w, resid))
            for t in range(s, k):
                blk = jnp.einsum("esb,ebt->est", js_w, jacs[t])
                Hpp_extra = Hpp_extra.at[
                    idx[s][:, :, None], idx[t][:, None, :]].add(blk)
                if t != s:
                    Hpp_extra = Hpp_extra.at[
                        idx[t][:, :, None], idx[s][:, None, :]].add(
                        jnp.swapaxes(blk, 1, 2))
    has_extra = bool(pattern.pose_only_keys)

    # dense-Schur operand: densify W into [Tp, dl*L] ONCE per
    # linearization (it is lambda-independent, so LM trial retries reuse
    # it) through the static one-hot selector — a batched-over-landmarks
    # contraction, no gathers/scatters. See the _DENSE_SCHUR gates.
    pose_groups = [g for g in problem.static.vgroups
                   if g.offset < problem.static.pose_dim]
    B2 = None
    if dense_ok:
        parts = []
        for g in pose_groups:
            D = g.tangent_dim
            bg = jnp.zeros((g.count * D, dl * L), dt)
            for pd in proj_data:
                pg = pd["pg"]
                if pg.cam_group != g.name:
                    continue
                W4 = pd["W_lm"][0].reshape(pd["Dp"], dl, -1, L)
                # HIGHEST: in TF32 the densify would round W itself
                bg = bg + jnp.einsum("ckl,stkl->cstl",
                                     pg.lm_cam_onehot, W4,
                                     precision=jax.lax.Precision.HIGHEST
                                     ).reshape(
                    g.count * D, dl * L)
            parts.append(bg)
        B2 = jnp.concatenate(parts, axis=0)

    return {"Hll": Hll, "b_l": b_l, "groups": groups, "proj": proj_data,
            "Hpp_extra": Hpp_extra, "b_extra": b_extra, "B2": B2,
            "has_extra": has_extra, "L": L, "dl": dl, "Tp": Tp}


def _solve(problem: Problem, pattern: BAEllPattern, sys, lam,
           pcg_iters: int, pcg_tol: float = 1e-10):
    """Damped Schur solve on the lane-major dual-ELL structures.

    Returns (dxT: lane-major part dict incl. landmarks, ok, bT: lane-major
    right-hand side parts for the gain-ratio denominator)."""
    dt = problem.dtype
    lg = problem.static.vgroup(pattern.lm_name)
    L, dl = sys["L"], sys["dl"]
    Hll, b_l = sys["Hll"], sys["b_l"]                    # [dl, dl, L], [dl, L]
    free_l = problem.free[lg.name]                       # [L]
    Hll_d = Hll + _eye_lane(dl, dt) * (lam * free_l + (1.0 - free_l))[None,
                                                                      None]
    Hinv = _inv_lane(Hll_d)                              # [dl, dl, L]

    pose_groups = [g for g in problem.static.vgroups
                   if g.offset < problem.static.pose_dim]
    free_p = {g.name: problem.free[g.name] for g in pose_groups}

    # damped block-diagonal Hcc per group (+ unit diagonal on fixed slots)
    Hcc_d = {}
    for g in pose_groups:
        D = g.tangent_dim
        eye = _eye_lane(D, dt)
        base = sys["groups"].get(g.name, {"Hcc": jnp.zeros(
            (D, D, g.count), dt)})["Hcc"]
        f = free_p[g.name][None, None]
        Hcc_d[g.name] = (base + lam * eye) * f + (1.0 - f) * eye

    has_extra = sys["has_extra"]

    # the dense pose-pose extra works on the flat [Tp] tangent ordering
    # ([C, Dp] row-major); transposes only run when such edges exist
    def parts_to_flat(partsT):
        return jnp.concatenate([partsT[g.name].T.reshape(-1)
                                for g in pose_groups])

    def flat_to_parts(x):
        out = {}
        for g in pose_groups:
            seg = jax.lax.dynamic_slice(x, (g.offset,),
                                        (g.count * g.tangent_dim,))
            out[g.name] = seg.reshape(g.count, g.tangent_dim).T
        return out

    hib = _bmv_lane(Hinv, b_l)                           # [dl, L]
    b_p = {g.name: sys["groups"].get(g.name, {"bT": jnp.zeros(
        (g.tangent_dim, g.count), dt)})["bT"] for g in pose_groups}
    if has_extra:
        extra = flat_to_parts(sys["b_extra"])
        b_p = {k: b_p[k] + extra[k] for k in b_p}

    if sys["B2"] is not None:
        # ---- dense Schur: W was densified once per linearization in
        # _build (B2, [Tp, dl*L]); the per-trial work is one batched
        # Hll^-1 application, one matmul for S = Hcc - W Hinv W^T, and
        # one [Tp, Tp] Cholesky. No PCG loop: the solve is exact, and the
        # rhs/back-substitution couplings become dense matvecs too.
        from openslam_g2o_tpu.core.solvers import solve_dense_cholesky
        Tp = sys["Tp"]
        B2 = sys["B2"]
        B2r = B2.reshape(Tp, dl, L)
        # the dense route's products run HIGHEST: in TF32 (the H100
        # default for float32 matmuls) they left a >1e-3 error in the
        # exact step (chip_smoke schur_step_exact); the LM gates tolerate
        # it, an exact solver should not
        hi = jax.lax.Precision.HIGHEST
        HB2 = jnp.einsum("utl,ctl->cul", Hinv, B2r,
                         precision=hi).reshape(Tp, dl * L)
        # fuse the reduced-rhs coupling B2 @ hib into the S matmul as one
        # extra output column: the [Tp, dl*L] B2 operand (72 MB at the 80k
        # bench shape) streams from memory ONCE for both products
        M2 = jnp.concatenate([HB2.T, hib.reshape(-1, 1)], axis=1)
        SR = jnp.matmul(B2, M2, precision=hi)           # [Tp, Tp + 1]
        S_corr = SR[:, :Tp]
        B2hib = SR[:, Tp]
        S = -0.5 * (S_corr + S_corr.T)
        for g in pose_groups:
            D = g.tangent_dim
            gidx = (g.offset + jnp.arange(g.count)[:, None] * D
                    + jnp.arange(D)[None, :])
            S = S.at[gidx[:, :, None], gidx[:, None, :]].add(
                jnp.moveaxis(Hcc_d[g.name], -1, 0))
        if has_extra:
            S = S + sys["Hpp_extra"]
        free_flat = parts_to_flat({k: jnp.broadcast_to(
            free_p[k][None], b_p[k].shape) for k in b_p})
        b_flat = (parts_to_flat(b_p) - B2hib) * free_flat
        dx_flat, ok = solve_dense_cholesky(S, b_flat)
        dx_p = flat_to_parts(dx_flat * free_flat)
        u = jnp.matmul(B2.T, dx_flat, precision=hi).reshape(dl, L)
    else:
        # ---- implicit matrix-free PCG on S, block-Jacobi preconditioned
        b_red = dict(b_p)
        for pd in sys["proj"]:
            pg = pd["pg"]
            Cc = problem.static.vgroup(pg.cam_group).count
            b_red[pg.cam_group] = b_red[pg.cam_group] - _apply_w_lane(
                pd["W_cam"], pg.cam_buckets, pg.cam_perm, hib, pd["Dp"],
                dl, to_lm=False, n_out=Cc)
        b_red = {k: b_red[k] * free_p[k][None] for k in b_red}

        def s_matvec(xT):
            """Implicit S x = (Hcc - W Hll^-1 W^T) x, owner-on-lanes:
            gathers touch only the small [D, N] vector tables; the heavy W
            tables are read sequentially by the multiply-reduces."""
            y = {g.name: _bmv_lane(Hcc_d[g.name], xT[g.name])
                 for g in pose_groups}
            if has_extra:
                flat = sys["Hpp_extra"] @ parts_to_flat(xT)
                extra = flat_to_parts(flat)
                y = {k: y[k] + extra[k] for k in y}
            u = jnp.zeros((dl, L), dtype=dt)
            for pd in sys["proj"]:
                pg = pd["pg"]
                u = u + _apply_w_lane(pd["W_lm"], pg.lm_buckets,
                                      pg.lm_perm, xT[pg.cam_group],
                                      pd["Dp"], dl, to_lm=True, n_out=L)
            v = _bmv_lane(Hinv, u)
            for pd in sys["proj"]:
                pg = pd["pg"]
                y[pg.cam_group] = y[pg.cam_group] - _apply_w_lane(
                    pd["W_cam"], pg.cam_buckets, pg.cam_perm, v, pd["Dp"],
                    dl, to_lm=False,
                    n_out=problem.static.vgroup(pg.cam_group).count)
            return y

        s_blocks = dict(Hcc_d)
        for pd in sys["proj"]:
            pg = pd["pg"]
            corr = _sandwich_lane(
                pd["W_cam"], pg.cam_buckets, pg.cam_perm, Hinv, pd["Dp"],
                dl, n_out=problem.static.vgroup(pg.cam_group).count)
            s_blocks[pg.cam_group] = s_blocks[pg.cam_group] - corr
        s_binv = {k: _inv_lane(v) for k, v in s_blocks.items()}

        def precond(rT):
            return {k: _bmv_lane(s_binv[k], rT[k]) for k in rT}

        dx_p, ok = pcg_solve(s_matvec, b_red, precond=precond,
                             max_iter=pcg_iters, tol=pcg_tol, norm="precond",
                             unroll=2)
        dx_p = {k: dx_p[k] * free_p[k][None] for k in dx_p}
        # back-substitution coupling: u = W^T dx_p
        u = jnp.zeros((dl, L), dtype=dt)
        for pd in sys["proj"]:
            pg = pd["pg"]
            u = u + _apply_w_lane(pd["W_lm"], pg.lm_buckets, pg.lm_perm,
                                  dx_p[pg.cam_group], pd["Dp"], dl,
                                  to_lm=True, n_out=L)

    # back-substitution: dx_l = Hll^-1 (b_l - W^T dx_p)
    dx_l = _bmv_lane(Hinv, b_l - u) * free_l[None]

    dxT = dict(dx_p)
    dxT[pattern.lm_name] = dx_l
    bT = dict(b_p)
    bT[pattern.lm_name] = b_l
    return dxT, ok, bT


@partial(jax.jit, static_argnames=("max_trials", "pcg_iters", "pcg_tol",
                                   "peel"))
def _lm_ba_ell_step(prob: Problem, pattern: BAEllPattern, params: dict,
                    lam, ni, chi_cur, max_trials: int = 10,
                    pcg_iters: int = 100, pcg_tol: float = 1e-10,
                    peel: bool = True):
    """One LM iteration on the dual-ELL Schur solver (same trial semantics
    as the reference LM, optimization_algorithm_levenberg.cpp:95-142)."""
    from openslam_g2o_tpu.core.problem import apply_update_parts
    from openslam_g2o_tpu.core.solvers import _tree_dot

    work = prob.with_params(params)
    lin = linearize(work)
    sys = _build(work, pattern, lin)

    def trial_cond(st):
        trials, done, rho = st[0], st[1], st[2]
        return jnp.logical_and(jnp.logical_not(done),
                               jnp.logical_and(rho < 0, trials < max_trials))

    def trial_body(st):
        trials, done, rho, lam, ni, best_params, best_chi = st
        dxT, ok, bT = _solve(work, pattern, sys, lam, pcg_iters,
                             pcg_tol=pcg_tol)
        dx = {k: v.T for k, v in dxT.items()}
        cand = apply_update_parts(work, dx)
        chi_new = robust_chi2(work, cand)
        # non-finite trial chi2 behaves like a failed solve: rho pinned
        # negative so the while_loop retries with larger lambda (a NaN
        # rho would end the trial loop — see algorithms._lm_step)
        solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
        chi_new = jnp.where(solved, chi_new, jnp.inf)
        scale = _tree_dot(dxT, jax.tree_util.tree_map(
            lambda d, bi: lam * d + bi, dxT, bT)) + 1e-3
        rho = jnp.where(solved, (chi_cur - chi_new) / scale, -1.0)
        accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))
        alpha = 1.0 - (2.0 * rho - 1.0) ** 3
        good = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
        lam = jnp.where(accept, lam * good, lam * ni)
        ni = jnp.where(accept, 2.0, ni * 2.0)
        best_params = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), cand, best_params)
        best_chi = jnp.where(accept, chi_new, best_chi)
        return trials + 1, accept, rho, lam, ni, best_params, best_chi

    init = (jnp.int32(0), jnp.array(False), jnp.array(-1.0, prob.dtype),
            lam, ni, params, chi_cur)
    # peel the FIRST trial out of the while_loop: with the common
    # accepted-first-try case outside, the loop body only executes on
    # lambda retries. peel=False keeps the whole trial inside the loop (the
    # configuration the dispatcher picks for chunk-scanned patterns, see
    # _fused_chunk_unsafe). Both forms compute the same trajectory.
    first = trial_body(init) if peel else init
    trials, accepted, rho, lam, ni, best_params, best_chi = jax.lax.while_loop(
        trial_cond, trial_body, first)
    return best_params, lam, ni, best_chi, trials, accepted


@partial(jax.jit, static_argnames=("pcg_iters", "pcg_tol"))
def _ba_trial(prob: Problem, pattern: BAEllPattern, params: dict, lam,
              chi_cur, pcg_iters: int = 100, pcg_tol: float = 1e-10):
    """One LM TRIAL as its own device program: linearize + build + solve +
    candidate chi2 + gain ratio (the _lm_ba_ell_step trial body, unrolled
    for the host-driven loop below)."""
    from openslam_g2o_tpu.core.problem import apply_update_parts
    from openslam_g2o_tpu.core.solvers import _tree_dot

    work = prob.with_params(params)
    lin = linearize(work)
    sys = _build(work, pattern, lin)
    dxT, ok, bT = _solve(work, pattern, sys, lam, pcg_iters, pcg_tol=pcg_tol)
    dx = {k: v.T for k, v in dxT.items()}
    cand = apply_update_parts(work, dx)
    chi_new = robust_chi2(work, cand)
    solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
    chi_new = jnp.where(solved, chi_new, jnp.inf)
    scale = _tree_dot(dxT, jax.tree_util.tree_map(
        lambda d, bi: lam * d + bi, dxT, bT)) + 1e-3
    rho = jnp.where(solved, (chi_cur - chi_new) / scale, -1.0)
    return cand, chi_new, rho


def _lm_ba_ell_step_host(prob: Problem, pattern: BAEllPattern, params: dict,
                         lam, ni, chi_cur, max_trials: int = 10,
                         pcg_iters: int = 100, pcg_tol: float = 1e-10):
    """_lm_ba_ell_step with the LM trial loop on the HOST (one jitted trial
    program per attempt, one scalar sync each).

    Used for multi-bucket (sliced-ELL) patterns, whose solve programs run
    as standalone jits rather than nested inside lax.while_loop. The host
    loop costs one rho readback per trial; semantics are identical to the
    fused trial loop (optimization_algorithm_levenberg.cpp:95-142)."""
    import math

    trials = 0
    for _ in range(max_trials):
        cand, chi_new, rho = _ba_trial(prob, pattern, params, lam, chi_cur,
                                       pcg_iters=pcg_iters, pcg_tol=pcg_tol)
        trials += 1
        rho_f = float(rho)
        chi_f = float(chi_new)
        if rho_f > 0 and math.isfinite(chi_f):
            alpha = 1.0 - (2.0 * rho_f - 1.0) ** 3
            good = min(max(alpha, 1.0 / 3.0), 2.0 / 3.0)
            return (cand, lam * good, jnp.asarray(2.0, prob.dtype), chi_new,
                    trials, True)
        lam = lam * ni
        ni = ni * 2.0
    return params, lam, ni, chi_cur, trials, False


def _wants_host_trials(pattern: BAEllPattern) -> bool:
    """True when the pattern routes to multi-bucket tables, which run the
    host-driven trial loop (see _BUCKET_ENABLE). Chunk-scanned
    single-table patterns stay on the fused while step, unpeeled."""
    return any(len(pg.cam_buckets) > 1 or len(pg.lm_buckets) > 1
               for pg in pattern.proj)


def _has_chunked(pattern: BAEllPattern) -> bool:
    return any(b[1].ndim == 3 for pg in pattern.proj
               for b in pg.cam_buckets + pg.lm_buckets)


def _fused_chunk_unsafe(problem, pattern: BAEllPattern) -> bool:
    """True when a fused/peeled trial would actually EXECUTE chunk-scanned
    kernels; such patterns run the unpeeled while step only (a guard kept
    from the previous accelerator's toolchain, where the peeled and
    trial-per-iteration forms of these kernels miscomputed; both routes
    are plain JAX and re-deciding the guard is ROADMAP Design item 3). On
    the dense-Schur route the chunked camera-side tables are DEAD operands
    (_build skips _reduce_k_lane and the W_cam gather when cam_onehot/B2
    exist), so chunking there does not gate the fused runner: the 80k
    bench shape has a 3x512-chunk camera table yet runs fully dense."""
    if not _has_chunked(pattern):
        return False
    if not dense_schur_ok(problem, pattern):
        return True
    # dense route: lm-side chunking always executes (Hll/b_l owner
    # reduces run _reduce_k_lane on lm_buckets). The CAMERA-side reduce
    # would also fall back to _reduce_k_lane if cam_onehot were gated out
    # (_build:582-607); with the CURRENT gates that cannot co-occur with
    # dense_schur_ok (E_g <= K_l*L, so the E*C operand never exceeds the
    # C*K_l*L lm-onehot operand that dense_schur_ok requires) — the
    # cam_buckets term below is defensive hardening so the guard stays
    # correct if either operand gate is ever tuned independently
    return any(
        any(b[1].ndim == 3 for b in pg.lm_buckets)
        or (pg.cam_onehot is None
            and any(b[1].ndim == 3 for b in pg.cam_buckets))
        for pg in pattern.proj)


def ba_ell_step(prob: Problem, pattern: BAEllPattern, params: dict, lam, ni,
                chi_cur, max_trials: int = 10, pcg_iters: int = 100,
                pcg_tol: float = 1e-10):
    """Dispatch one LM iteration: the fused while_loop step, or the
    host-driven trial loop for multi-bucket patterns (see
    _lm_ba_ell_step_host)."""
    if _wants_host_trials(pattern):
        return _lm_ba_ell_step_host(prob, pattern, params, lam, ni, chi_cur,
                                    max_trials=max_trials,
                                    pcg_iters=pcg_iters, pcg_tol=pcg_tol)
    return _lm_ba_ell_step(prob, pattern, params, lam, ni, chi_cur,
                           max_trials=max_trials, pcg_iters=pcg_iters,
                           pcg_tol=pcg_tol,
                           peel=not _fused_chunk_unsafe(prob, pattern))


@partial(jax.jit, static_argnames=("n_iters", "max_trials", "pcg_iters",
                                   "pcg_tol", "peel", "trial_per_iter"))
def ba_ell_optimize_fused(prob: Problem, pattern: BAEllPattern, params: dict,
                          lam, ni, chi, n_iters: int = 10,
                          max_trials: int = 10, pcg_iters: int = 100,
                          pcg_tol: float = 1e-10, peel: bool = True,
                          trial_per_iter: bool = True):
    """Run n_iters dual-ELL Schur LM iterations as ONE device program
    (lax.scan) — no host round-trip between iterations, the same shape as
    the pose-graph lm_pcg_optimize_fused.

    trial_per_iter=True (default) runs ONE LM trial per scan iteration
    with no inner while_loop: a rejected trial leaves params unchanged and
    doubles lambda, so the next iteration re-linearizes the IDENTICAL
    system and re-tries — the exact trajectory of the reference trial loop
    (optimization_algorithm_levenberg.cpp:95-142), just unrolled across
    scan steps, with no live while_loop in the body. n_iters then counts
    TRIALS, not accepted steps, and max_trials is not consulted (the
    budget bounds the retries instead).

    trial_per_iter=False scans the full while-loop step — the
    configuration for exact iteration accounting; chunk-scanned patterns
    must use it with peel=False (see _fused_chunk_unsafe). Either way the
    pattern must not route to host trials (_wants_host_trials).

    Returns (params, lam, ni, chi, chi_trajectory [n_iters])."""
    from openslam_g2o_tpu.core.problem import apply_update_parts
    from openslam_g2o_tpu.core.solvers import _tree_dot

    # trace-time guard: the dispatch rules of ba_ell_step also hold for
    # the public fused API
    if _wants_host_trials(pattern):
        raise ValueError(
            "ba_ell_optimize_fused: multi-bucket patterns run the "
            "host-driven trial loop; use ba_ell_step, which dispatches it")
    if _fused_chunk_unsafe(prob, pattern) and (trial_per_iter or peel):
        raise ValueError(
            "ba_ell_optimize_fused: patterns whose chunk-scanned kernels "
            "execute in the trial run only with trial_per_iter=False, "
            "peel=False (see _fused_chunk_unsafe); pass those settings or "
            "use ba_ell_step")
    if trial_per_iter:
        def body(carry, _):
            params, lam, ni, chi = carry
            work = prob.with_params(params)
            sys = _build(work, pattern, linearize(work))
            dxT, ok, bT = _solve(work, pattern, sys, lam, pcg_iters,
                                 pcg_tol=pcg_tol)
            dx = {k: v.T for k, v in dxT.items()}
            cand = apply_update_parts(work, dx)
            chi_new = robust_chi2(work, cand)
            solved = jnp.logical_and(ok, jnp.isfinite(chi_new))
            chi_new = jnp.where(solved, chi_new, jnp.inf)
            scale = _tree_dot(dxT, jax.tree_util.tree_map(
                lambda d, bi: lam * d + bi, dxT, bT)) + 1e-3
            rho = jnp.where(solved, (chi - chi_new) / scale, -1.0)
            accept = jnp.logical_and(rho > 0, jnp.isfinite(chi_new))
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            good = jnp.maximum(1.0 / 3.0, jnp.minimum(alpha, 2.0 / 3.0))
            lam = jnp.where(accept, lam * good, lam * ni)
            ni = jnp.where(accept, 2.0, ni * 2.0)
            params = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old), cand, params)
            chi = jnp.where(accept, chi_new, chi)
            return (params, lam, ni, chi), chi
    else:
        def body(carry, _):
            params, lam, ni, chi = carry
            params, lam, ni, chi, trials, ok = _lm_ba_ell_step.__wrapped__(
                prob, pattern, params, lam, ni, chi, max_trials=max_trials,
                pcg_iters=pcg_iters, pcg_tol=pcg_tol, peel=peel)
            return (params, lam, ni, chi), chi

    (params, lam, ni, chi), traj = jax.lax.scan(
        body, (params, lam, ni, chi), None, length=n_iters)
    return params, lam, ni, chi, traj


class LevenbergMarquardtSchurELL:
    """LM + dual-ELL Schur: the production BA configuration."""

    name = "lm_schur_ell"

    def __init__(self, initial_lambda: float = 0.0,
                 max_trials_after_failure: int = 10, tau: float = 1e-5,
                 pcg_iters: int = 100, pcg_tol: float = 1e-10):
        self.initial_lambda = initial_lambda
        self.max_trials = max_trials_after_failure
        self.tau = tau
        self.pcg_iters = pcg_iters
        self.pcg_tol = pcg_tol
        self._pattern = None
        self._pattern_for = None

    def pattern(self, prob: Problem):
        if self._pattern_for is not prob.static:
            self._pattern = build_ba_ell_pattern(prob)
            self._pattern_for = prob.static
        return self._pattern

    def init(self, prob: Problem):
        pattern = self.pattern(prob)
        if self.initial_lambda > 0:
            lam = jnp.asarray(self.initial_lambda, prob.dtype)
        else:
            # tau * max |diag(H)| over landmark AND camera blocks
            # (computeLambdaInit, optimization_algorithm_levenberg.cpp:149-163)
            def max_diag(l):
                sys = _build(prob, pattern, l)
                m = jnp.max(jnp.abs(_diag_lane(sys["Hll"])))
                for g in sys["groups"].values():
                    m = jnp.maximum(m, jnp.max(jnp.abs(_diag_lane(g["Hcc"]))))
                if sys["has_extra"]:
                    m = jnp.maximum(m, jnp.max(jnp.abs(
                        jnp.diagonal(sys["Hpp_extra"]))))
                return m

            lin = linearize(prob)
            m = jax.jit(max_diag)(lin)
            lam = jnp.asarray(self.tau, prob.dtype) * m
        return {"params": prob.params, "lam": lam,
                "ni": jnp.asarray(2.0, prob.dtype),
                "chi2": robust_chi2(prob)}

    def step(self, prob: Problem, state: dict):
        params, lam, ni, chi, trials, accepted = ba_ell_step(
            prob, self.pattern(prob), state["params"], state["lam"],
            state["ni"], state["chi2"],
            max_trials=self.max_trials, pcg_iters=self.pcg_iters,
            pcg_tol=self.pcg_tol)
        new_state = {"params": params, "lam": lam, "ni": ni, "chi2": chi}
        info = {"chi2": float(chi), "lambda": float(lam),
                "levenberg_iters": int(trials), "ok": bool(accepted)}
        return new_state, info
