"""Block-ELL sparse Hessian: the block-sparse matrix structure.

The reference stores the Hessian as column maps of heap blocks
(SparseBlockMatrix, g2o/core/sparse_block_matrix.h:61-225) and converts to
scalar CCS for CSparse/CHOLMOD. Neither vectorizes: pointer-chasing and
scalar CCS SpMV are serial, and scatters serialize on collisions. Instead
we use a
block ELLPACK layout per (row-group, col-group) pair, held LANE-MAJOR:

    values:  [D_row * D_col, N_rows, K]   (K = max block-neighbors, padded)
    nb_idx:  [N_rows, K] int32            (column vertex local index; padding
                                           points at vertex 0 with zero value)

Why lane-major: with N on the minor axis the SpMV gather is a [D, N] take
along that axis and the contraction a pure elementwise multiply + K-axis
reduce; the row-major form (gather of [N, D] rows + a batched
[N, K, D, D] x [N, K, D] einsum) turns into tiny batched dots. The layout
was chosen for the previous accelerator's gather cost; whether it is the
right one for the H100 is ROADMAP Design item 4.

* Assembly is also scatter-free: every (edge, slot-pair) contribution gets a
  host-precomputed DESTINATION-major contributor table [N*K, M] (M = max
  contributions per block, i.e. the vertex degree on diagonal slots), so
  accumulation is one lane gather + masked sum — the same trick the dual-ELL
  BA solver uses (core/ba_ell.py), replacing an XLA scatter.
* Small batched matrix products (J^T W J etc.) are expanded to elementwise
  multiply + reduce (`bmm_small`) instead of einsum, which lowers batched
  3x3 dots to tiny matmul calls.

The same layout is the natural input for a future fused CG-iteration
kernel (ROADMAP Speed item 3).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["EllPattern", "build_ell_pattern", "assemble_ell", "ell_matvec",
           "ell_matvec_lane", "bmm_small", "ell_split_tiers_kmajor",
           "ell_matvec_lane_kmajor_tiered", "assemble_hot",
           "hot_diag_blocks", "hot_add_diag", "hot_scale_jacobi",
           "hot_split", "hot_gershgorin_bound"]

# Above this many int32 entries in one contributor table, fall back to the
# scatter assembly (a pathological hub vertex would otherwise explode the
# dest-major table; bundled pose graphs are orders of magnitude below this).
_CONTRIB_TABLE_LIMIT = 50_000_000

# DIA split knobs (EllPattern dia_* docstring): at most this many band
# offsets; an offset qualifies when it appears on at least this fraction
# of rows (a sparser diagonal wastes dense multiplies on zeros).
_DIA_MAX_OFFSETS = 8
_DIA_MIN_ROW_FRAC = 0.2


def bmm_small(A, B):
    """Batched matmul for small trailing dims via elementwise multiply +
    reduce: C[..., i, j] = sum_k A[..., i, k] B[..., k, j]. Elementwise
    work that fuses; einsum would issue tiny per-batch dots."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(axis=-2)


def bmv_small(A, v):
    """Batched matrix-vector product: y[..., i] = sum_k A[..., i, k] v[..., k]."""
    return (A * v[..., None, :]).sum(axis=-1)


@partial(jax.tree_util.register_dataclass,
         data_fields=["nb_idx", "positions", "contrib_idx", "contrib_mask",
                      "b_idx", "b_mask", "self_mask", "tier_rows",
                      "tier_lo_nbT", "tier_hi_nbT", "dia_src", "dia_mask",
                      "res_srcT", "res_nbT", "res_maskT", "contrib_base",
                      "b_base", "dia_asm", "dia_sh"],
         meta_fields=["pairs", "K", "pair_of", "contrib_m", "b_m",
                      "b_sources", "tier_kb", "dia_offsets", "res_k",
                      "dia_asm_m", "dia_sh_meta"])
@dataclass
class EllPattern:
    """Static-topology ELL pattern for the whole block Hessian.

    pairs: tuple of (row_group, col_group) names, one per ELL table.
    K: tuple of neighbor counts per table.
    nb_idx: tuple of [N_row, K] int32 neighbor tables.
    positions: dict (egroup_key, s, t) -> [E] int32 neighbor-slot positions
        (used by the scatter fallback and the distributed assembly path).
    pair_of: tuple of ((egroup_key, s, t), pair_table_id) — static routing.
    contrib_idx/mask: per pair, dest-major contributor tables
        [N*K, M] int32 / float mask into the concatenated per-edge block
        stream of that pair (None -> scatter fallback).
    b_idx/mask: per vertex group, [N, Mb] contributor tables into the
        concatenated per-edge b-block stream of that group.
    b_sources: dict group -> tuple of (egroup_key, slot) in stream order.
    self_mask: per pair, [N, K] float mask of the (i, i) self slot (None for
        off-diagonal pairs) — lets LM damping fold into the values once per
        trial (ell_add_diag) instead of one extra op pair per matvec.
    tier_*: two-tier (base + overflow) split of the K axis for the hot-loop
        matvec. The per-iteration cost of the K-major matvec is GATHER
        THROUGHPUT, and a uniform
        K = max-degree table wastes most of it on padding (Manhattan: K=10,
        mean degree 5.1). tier_kb[pid] = Kb chosen to minimize total
        gathered elements N*Kb + N_hi*(K-Kb); tier_rows = [N_hi] int32
        rows with degree > Kb; tier_lo_nbT = [Kb, N] / tier_hi_nbT =
        [K-Kb, N_hi] transposed neighbor tables. None/K when a single tier
        is already optimal.
    dia_*: DIA (diagonal-band) split — the round-4 answer to the same
        gather-throughput limit. On chain/grid/serpentine graphs most
        neighbor slots sit at a few CONSTANT index offsets (odometry i+-1,
        inter-sweep closures i+-sweep, the self diagonal 0); for those the
        matvec's x-gather becomes a static SHIFT (dense pad+slice, no
        gather). dia_offsets[pid] = tuple of
        selected static offsets (None -> pair stays on the tier path);
        dia_src/dia_mask = [m, N] source-slot tables re-laying values_k
        into offset-major form once per trial; res_srcT/res_nbT/res_maskT
        = [K_res, N] compacted tables of the slots NOT covered by any
        selected offset (the only gathers left in the hot loop);
        res_k[pid] = K_res. Selection + activation are host-side cost
        decisions (build_ell_pattern).
    dia_asm: DIA-DIRECT assembly tables (round 5) — contributor tables
        laid out straight into the offset-major hot form, so assembly
        emits ("dia", V_dia [Dr*Dc, m, N], V_res [Dr*Dc, K_res, N])
        with no per-trial values->kmajor transpose or take_along_axis
        re-lay, AND each destination class carries its own tight M:
        the self-diagonal plane (offset 0, first in dia_offsets) sums
        M_self = max vertex degree contributions while off-diagonal
        planes are typically M=1 — vs the uniform [N*K, M_max] table,
        whose padded gathers dominated the per-trial cost on the
        previous accelerator. Per pair, None or a
        tuple (self_idxT [Ms, N] or None, self_maskT, off_idxT
        [Mo, m_off*N] or None, off_maskT, res_idxT [Mr, K_res*N] or
        None, res_maskT) of int32/f32 tables indexing the pair's
        lane-major contribution stream; dia_asm_m holds the matching
        (Ms, Mo, Mr, m_off, has_self) static meta.
    """
    nb_idx: tuple
    positions: dict
    contrib_idx: tuple
    contrib_mask: tuple
    b_idx: dict
    b_mask: dict
    self_mask: tuple
    tier_rows: tuple
    tier_lo_nbT: tuple
    tier_hi_nbT: tuple
    dia_src: tuple
    dia_mask: tuple
    res_srcT: tuple
    res_nbT: tuple
    res_maskT: tuple
    contrib_base: tuple
    b_base: dict
    dia_asm: tuple
    dia_sh: tuple
    pairs: tuple
    K: tuple
    pair_of: tuple
    contrib_m: tuple
    b_m: dict
    b_sources: dict
    tier_kb: tuple
    dia_offsets: tuple
    res_k: tuple
    dia_asm_m: tuple
    dia_sh_meta: tuple

    def pair_table(self, key):
        return dict(self.pair_of)[key]

    def diag_blocks(self, problem, values):
        """Extract the [N, D, D] diagonal blocks per group from the
        lane-major ELL tables (the self-neighbor slot) — no extra assembly
        pass needed."""
        out = {}
        for pid, (rg_name, cg_name) in enumerate(self.pairs):
            if rg_name != cg_name:
                continue
            g = problem.static.vgroup(rg_name)
            D = g.tangent_dim
            nb = self.nb_idx[pid]                       # [N, K]
            rows = jnp.arange(g.count, dtype=jnp.int32)
            is_self = nb == rows[:, None]
            # slot of the self neighbor (0 if the row has no edges — its
            # value block is zero there, which is the correct empty diagonal)
            slot = jnp.argmax(is_self, axis=1)
            v = values[pid]                             # [D*D, N, K]
            blk = jnp.take_along_axis(v, slot[None, :, None], axis=2)[..., 0]
            blk = jnp.moveaxis(blk, 0, 1).reshape(g.count, D, D)
            out[rg_name] = blk * jnp.any(is_self, axis=1)[:, None, None]
        for g in problem.static.vgroups:
            if g.name not in out:
                out[g.name] = jnp.zeros(
                    (g.count, g.tangent_dim, g.tangent_dim),
                    dtype=problem.dtype)
        return out


def _contrib_tables(dest, n_dest, stream_idx=None):
    """Sorted contributor ELL: [n_dest, M] indices into the contribution
    stream + mask, PLUS the base+overflow form — base_idx/base_mask
    [n_dest] holding each slot's FIRST contribution and (ov_dest, ov_src)
    flat lists of the rest (round 4: the uniform [n_dest, M] gather wastes
    ~Mx gather throughput when most slots hold one contribution; the base
    form gathers one element per slot and scatter-ADDS the small overflow
    once per trial, outside every hot loop). None if the table would
    exceed the size limit.

    stream_idx: optional [len(dest)] positions of these contributions in
    the FULL per-edge stream (used when invalid/padding edges were dropped
    from `dest` but still occupy stream slots)."""
    counts = np.bincount(dest, minlength=n_dest)
    M = max(int(counts.max()) if len(dest) else 1, 1)
    if n_dest * M > _CONTRIB_TABLE_LIMIT:
        return None, None, M, None
    order = np.argsort(dest, kind="stable").astype(np.int64)
    tbl = np.zeros((n_dest, M), dtype=np.int32)
    mask = np.zeros((n_dest, M), dtype=np.float32)
    starts = np.zeros(n_dest + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    # column index of each sorted contribution within its destination row
    col = np.arange(len(dest), dtype=np.int64) - starts[dest[order]]
    src = order if stream_idx is None else stream_idx[order]
    tbl[dest[order], col] = src.astype(np.int32)
    mask[dest[order], col] = 1.0
    if (col == 0).all():
        # every slot has exactly one contribution: the base form (one
        # gathered element per slot) replaces the [n_dest, M] table
        base = (jnp.asarray(tbl[:, 0]), jnp.asarray(mask[:, 0]))
        cb = (base, None)
    else:
        # multi-contribution slots exist: the M-wide gather path is used
        # (a scatter-ADD overflow variant measured SLOWER at the 100k
        # shape, see _assemble_pair) — neither the base nor the overflow
        # arrays would ever be read, so store no device arrays at all
        cb = None
    return tbl, mask, M, cb


def build_ell_pattern(problem, edge_valid: dict = None) -> EllPattern:
    """Host-side symbolic phase: walk the edge tables once and lay out
    neighbor slots AND destination-major contributor tables.

    Every (edge, ordered slot pair (s, t)) contribution, including the
    diagonal (s, s), gets a fixed (row_vertex, neighbor_slot) position in the
    (group(s), group(t)) table; repeated (i, j) pairs across edges share a
    slot (their contributions sum, exactly like the reference's shared
    mapped Hessian blocks, block_solver.hpp:143-295).

    edge_valid: optional {egroup_key: [E] bool}. Edges marked invalid
    (e.g. the zero-information bucket padding of the incremental engine,
    which all point at vertex 0 and would otherwise explode the vertex-0
    contributor row) are EXCLUDED from the neighbor/contributor tables —
    their per-edge blocks are zero by construction, so dropping them is
    exact. Their `positions` entries are 0, which the scatter fallback adds
    harmlessly (zero blocks at slot 0).
    """
    # One host transfer per index column, then fully vectorized numpy: at
    # venice scale (~1e6 observations) this runs in well under a second where
    # a per-edge Python loop would take minutes.
    pair_names = []
    pair_counts = {}
    pair_rows = {}        # pair key -> list of (egkey, s, t, rows, cols)
    pair_of = []

    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        k = eg.etype.num_vertices
        groups = [problem.static.vgroup(g) for g in eg.slots]
        idx_np = [np.asarray(ea.indices[s]).astype(np.int64) for s in range(k)]
        for s in range(k):
            for t in range(k):
                rg, cg = groups[s], groups[t]
                key = (rg.name, cg.name)
                if key not in pair_counts:
                    pair_counts[key] = len(pair_names)
                    pair_names.append(key)
                    pair_rows[key] = []
                pair_rows[key].append((eg.key, s, t, idx_np[s], idx_np[t]))
                pair_of.append(((eg.key, s, t), pair_counts[key]))

    nb_idx = []
    Ks = []
    positions = {}
    contrib_idx = []
    contrib_mask = []
    contrib_m = []
    self_masks = []
    tier_rows_l = []
    tier_lo_l = []
    tier_hi_l = []
    tier_kb_l = []
    dia_src_l = []
    dia_mask_l = []
    res_srcT_l = []
    res_nbT_l = []
    res_maskT_l = []
    dia_offsets_l = []
    res_k_l = []
    contrib_base_l = []
    dia_asm_l = []
    dia_asm_m_l = []
    dia_sh_l = []
    dia_sh_m_l = []
    for key in pair_names:
        rg = problem.static.vgroup(key[0])
        cg = problem.static.vgroup(key[1])
        contribs = pair_rows[key]
        all_rows = np.concatenate([c[3] for c in contribs])
        all_cols = np.concatenate([c[4] for c in contribs])
        if edge_valid is None:
            vmask = np.ones(len(all_rows), dtype=bool)
        else:
            vmask = np.concatenate([
                np.asarray(edge_valid[c[0]], dtype=bool)
                if c[0] in edge_valid else np.ones(len(c[3]), dtype=bool)
                for c in contribs])
        flat = all_rows * cg.count + all_cols
        uniq, inverse_v = np.unique(flat[vmask], return_inverse=True)
        u_rows = uniq // cg.count
        u_cols = uniq % cg.count
        # neighbor slot of each unique (row, col): rank within its row
        # (uniq is sorted, so entries of one row are contiguous)
        row_starts = np.searchsorted(u_rows, np.arange(rg.count))
        slot_of_unique = np.arange(len(uniq)) - row_starts[u_rows]
        counts = np.bincount(u_rows.astype(np.int64), minlength=rg.count)
        K = max(int(counts.max()) if len(counts) else 1, 1)
        tbl = np.zeros((rg.count, K), dtype=np.int32)
        tbl[u_rows, slot_of_unique] = u_cols
        nb_idx.append(jnp.asarray(tbl))
        Ks.append(K)
        if key[0] == key[1]:
            # valid (non-padding) slots only: padding defaults to col 0,
            # which would otherwise fake a self slot on row 0
            valid = np.arange(K)[None, :] < counts[:, None]
            self_masks.append(jnp.asarray(
                (valid & (tbl == np.arange(rg.count)[:, None]))
                .astype(np.float32)))
        else:
            self_masks.append(None)
        # two-tier split (see EllPattern docstring): choose the base width
        # Kb minimizing gathered elements; only activate when it saves >15%
        tier_kb_val, rows_hi, lo_nbT, hi_nbT = K, None, None, None
        if K > 2:
            costs = [(rg.count * kb + int((counts > kb).sum()) * (K - kb), kb)
                     for kb in range(1, K)]
            best_cost, best_kb = min(costs)
            if best_cost < 0.85 * rg.count * K:
                tier_kb_val = best_kb
                rows_hi = np.nonzero(counts > best_kb)[0].astype(np.int32)
                lo_nbT = np.ascontiguousarray(tbl[:, :best_kb].T)
                hi_nbT = np.ascontiguousarray(tbl[rows_hi, best_kb:].T)
        tier_rows_l.append(None if rows_hi is None else jnp.asarray(rows_hi))
        tier_lo_l.append(None if lo_nbT is None else jnp.asarray(lo_nbT))
        tier_hi_l.append(None if hi_nbT is None else jnp.asarray(hi_nbT))
        tier_kb_l.append(tier_kb_val)

        # DIA (diagonal-band) split: pick constant index offsets covering
        # enough slots that shifting beats gathering (EllPattern dia_*
        # docstring). Cost model: a residual gather slot costs ~1 gathered
        # element per row; a dia slot ~0.15 (dense multiply at bandwidth).
        valid_slots = np.arange(K)[None, :] < counts[:, None]     # [N, K]
        offs = tbl.astype(np.int64) - np.arange(rg.count)[:, None]
        d_sel, d_src, d_mask, r_srcT, r_nbT, r_maskT, r_k = (
            None, None, None, None, None, None, 0)
        offs_flat = offs[valid_slots]
        if len(offs_flat):
            vals_u, cnts_u = np.unique(offs_flat, return_counts=True)
            order = np.argsort(-cnts_u)
            sel = [int(vals_u[i]) for i in order[:_DIA_MAX_OFFSETS]
                   if cnts_u[i] >= _DIA_MIN_ROW_FRAC * rg.count]
            # self-plane-first invariant: the hot pipeline folds damping
            # into plane 0 and reads diagonal blocks from it (hot_add_diag
            # / hot_diag_blocks), so offset 0 leads when present
            if sel and key[0] == key[1] and 0 in sel and sel[0] != 0:
                sel.remove(0)
                sel.insert(0, 0)
            if sel:
                is_cov = valid_slots & np.isin(offs, np.asarray(sel))
                res_counts = (valid_slots & ~is_cov).sum(axis=1)
                res_K = int(res_counts.max()) if len(res_counts) else 0
                tier_cost = (rg.count * tier_kb_val
                             + (0 if rows_hi is None
                                else len(rows_hi) * (K - tier_kb_val)))
                dia_cost = rg.count * (res_K + 0.15 * len(sel))
                if dia_cost < 0.7 * tier_cost:
                    m = len(sel)
                    d_src = np.zeros((m, rg.count), dtype=np.int32)
                    d_mask = np.zeros((m, rg.count), dtype=np.float32)
                    for j, d in enumerate(sel):
                        hit = valid_slots & (offs == d)
                        has = hit.any(axis=1)
                        d_src[j, has] = np.argmax(hit, axis=1)[has]
                        d_mask[j, has] = 1.0
                    r_k = res_K
                    if res_K:
                        rr_res, kk_res = np.nonzero(valid_slots & ~is_cov)
                        starts_r = np.zeros(rg.count + 1, dtype=np.int64)
                        np.cumsum(np.bincount(rr_res, minlength=rg.count),
                                  out=starts_r[1:])
                        col_res = np.arange(len(rr_res)) - starts_r[rr_res]
                        r_srcT = np.zeros((res_K, rg.count), dtype=np.int32)
                        r_nbT = np.zeros((res_K, rg.count), dtype=np.int32)
                        r_maskT = np.zeros((res_K, rg.count),
                                           dtype=np.float32)
                        r_srcT[col_res, rr_res] = kk_res
                        r_nbT[col_res, rr_res] = tbl[rr_res, kk_res]
                        r_maskT[col_res, rr_res] = 1.0
                    d_sel = tuple(sel)
        dia_src_l.append(None if d_src is None else jnp.asarray(d_src))
        dia_mask_l.append(None if d_mask is None else jnp.asarray(d_mask))
        res_srcT_l.append(None if r_srcT is None else jnp.asarray(r_srcT))
        res_nbT_l.append(None if r_nbT is None else jnp.asarray(r_nbT))
        res_maskT_l.append(None if r_maskT is None else jnp.asarray(r_maskT))
        dia_offsets_l.append(d_sel)
        res_k_l.append(r_k)

        pos_all = np.zeros(len(all_rows), dtype=np.int64)
        pos_all[vmask] = slot_of_unique[inverse_v]
        off = 0
        for egkey, s, t, rows, _ in contribs:
            n = len(rows)
            positions[(egkey, s, t)] = jnp.asarray(
                pos_all[off:off + n].astype(np.int32))
            off += n
        dest = (all_rows * K + pos_all).astype(np.int64)
        ci, cm, M, cb = _contrib_tables(
            dest[vmask], rg.count * K,
            stream_idx=np.nonzero(vmask)[0] if not vmask.all() else None)
        contrib_idx.append(None if ci is None else jnp.asarray(ci))
        contrib_mask.append(None if cm is None else jnp.asarray(cm))
        contrib_m.append(M)
        contrib_base_l.append(cb)

        # DIA-direct assembly tables (dia_asm docstring): per destination
        # class (self plane / off-diagonal planes / residual slots) its own
        # tight-M transposed contributor table, so assembly emits the hot
        # split layout with ~sum(actual contributions) gathered elements
        # instead of N*K*M_max
        d_asm, d_asm_meta = None, None
        d_sh, d_sh_meta = None, None
        if d_sel is not None and (key[0] != key[1] or d_sel[0] == 0):
            rows_c = all_rows[vmask]
            off_c = all_cols[vmask] - rows_c
            k_c = pos_all[vmask]
            spos = np.nonzero(vmask)[0] if not vmask.all() else None

            def _tbl_T(sub, dest_sub, n_dest):
                # stream positions of the subset's contributions (global
                # positions in the pair's concatenated per-edge stream)
                si = sub if spos is None else spos[sub]
                ti, tm, Mx, _ = _contrib_tables(
                    dest_sub.astype(np.int64), n_dest, stream_idx=si)
                if ti is None:
                    return None
                return (jnp.asarray(np.ascontiguousarray(ti.T)),
                        jnp.asarray(np.ascontiguousarray(tm.T)), Mx)

            has_self = key[0] == key[1] and d_sel[0] == 0
            sel_off = list(d_sel[1:]) if has_self else list(d_sel)
            is_self_c = (off_c == 0) if has_self \
                else np.zeros(len(off_c), dtype=bool)
            if sel_off:
                in_plane = np.isin(off_c, np.asarray(sel_off)) & ~is_self_c
            else:
                in_plane = np.zeros(len(off_c), dtype=bool)
            sub_self = np.nonzero(is_self_c)[0]
            sub_off = np.nonzero(in_plane)[0]
            sub_res = np.nonzero(~is_self_c & ~in_plane)[0]

            # STREAM-SHIFT split (round 5): contributions whose
            # dest_row - stream_position is CONSTANT over a large group
            # (trajectory-ordered odometry: edge e connects poses
            # (e, e+1), so its diagonal/off-diagonal blocks sit at fixed
            # offsets from its stream slot) assemble as pure STATIC
            # SLICES of the contribution stream — zero gather cost, and
            # the remaining contributor tables shrink their M. Masks
            # cover the conforming rows; non-conforming contributions
            # stay in the gather tables.
            pos_c = (np.arange(len(rows_c), dtype=np.int64)
                     if spos is None else spos.astype(np.int64))
            L_stream = len(all_rows)
            sh_masks = []
            sh_meta = []

            def _extract_shifts(sub, plane_idx, use_b):
                if not len(sub):
                    return sub
                deltas = rows_c[sub] - pos_c[sub]
                vals_d, cnts_d = np.unique(deltas, return_counts=True)
                keep = np.ones(len(sub), dtype=bool)
                for v, cnt in zip(vals_d, cnts_d):
                    neg_c = int(-v)
                    if cnt < max(0.3 * rg.count, 512):
                        continue
                    if not (0 <= neg_c <= L_stream - rg.count):
                        continue
                    mm = deltas == v
                    mask = np.zeros(rg.count, dtype=np.float32)
                    mask[rows_c[sub[mm]]] = 1.0
                    sh_masks.append(jnp.asarray(mask))
                    sh_meta.append((plane_idx, neg_c, bool(use_b)))
                    keep &= ~mm
                return sub[keep]

            if sel_off and len(sub_off):
                so_ = np.argsort(sel_off)
                sso_ = np.asarray(sel_off)[so_]
                po_all = so_[np.searchsorted(sso_, off_c[sub_off])]
                base_j = 1 if has_self else 0
                new_sub = [
                    _extract_shifts(sub_off[po_all == j], base_j + j,
                                    False)
                    for j in range(len(sel_off))]
                sub_off = (np.concatenate(new_sub) if new_sub
                           else sub_off)
            if has_self:
                sub_self = _extract_shifts(sub_self, 0, True)
            parts = []
            ok = True
            if has_self:
                t = _tbl_T(sub_self, rows_c[sub_self], rg.count)
                ok &= t is not None
                parts.append(t)
            else:
                parts.append(None)
            if sel_off and len(sub_off):
                so = np.argsort(sel_off)
                sso = np.asarray(sel_off)[so]
                po = so[np.searchsorted(sso, off_c[sub_off])]
                t = _tbl_T(sub_off, po * rg.count + rows_c[sub_off],
                           len(sel_off) * rg.count)
                ok &= t is not None
                parts.append(t)
            else:
                parts.append(None)
            if r_k and len(sub_res):
                resc = np.full((rg.count, K), -1, dtype=np.int64)
                resc[rr_res, kk_res] = col_res
                rcol = resc[rows_c[sub_res], k_c[sub_res]]
                ok &= (rcol >= 0).all()
                t = _tbl_T(sub_res, rcol * rg.count + rows_c[sub_res],
                           r_k * rg.count) if ok else None
                ok &= t is not None
                parts.append(t)
            else:
                ok &= len(sub_res) == 0
                parts.append(None)
            if ok:
                d_asm = tuple(x for p in parts
                              for x in ((p[0], p[1]) if p else (None, None)))
                d_asm_meta = (parts[0][2] if parts[0] else 0,
                              parts[1][2] if parts[1] else 0,
                              parts[2][2] if parts[2] else 0,
                              len(sel_off), has_self)
                if sh_masks:
                    d_sh = tuple(sh_masks)
                    d_sh_meta = tuple(sh_meta)
        dia_asm_l.append(d_asm)
        dia_asm_m_l.append(d_asm_meta)
        dia_sh_l.append(d_sh)
        dia_sh_m_l.append(d_sh_meta)

    # b contributor tables, one stream per vertex group
    b_idx = {}
    b_mask = {}
    b_m = {}
    b_base = {}
    b_sources = {}
    streams: dict = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        for s in range(eg.etype.num_vertices):
            gname = eg.slots[s]
            streams.setdefault(gname, []).append(
                (eg.key, s, np.asarray(ea.indices[s]).astype(np.int64)))
    for g in problem.static.vgroups:
        src = streams.get(g.name, [])
        b_sources[g.name] = tuple((k, s) for k, s, _ in src)
        if not src:
            b_idx[g.name] = None
            b_mask[g.name] = None
            b_m[g.name] = 1
            b_base[g.name] = None
            continue
        dest = np.concatenate([rows for _, _, rows in src])
        if edge_valid is None:
            bvmask = np.ones(len(dest), dtype=bool)
        else:
            bvmask = np.concatenate([
                np.asarray(edge_valid[k], dtype=bool) if k in edge_valid
                else np.ones(len(rows), dtype=bool)
                for k, _, rows in src])
        ci, cm, M, bb = _contrib_tables(
            dest[bvmask], g.count,
            stream_idx=np.nonzero(bvmask)[0] if not bvmask.all() else None)
        b_idx[g.name] = None if ci is None else jnp.asarray(ci)
        b_mask[g.name] = None if cm is None else jnp.asarray(cm)
        b_m[g.name] = M
        b_base[g.name] = bb

    return EllPattern(tuple(nb_idx), positions,
                      tuple(contrib_idx), tuple(contrib_mask), b_idx, b_mask,
                      tuple(self_masks),
                      tuple(tier_rows_l), tuple(tier_lo_l), tuple(tier_hi_l),
                      tuple(dia_src_l), tuple(dia_mask_l), tuple(res_srcT_l),
                      tuple(res_nbT_l), tuple(res_maskT_l),
                      tuple(contrib_base_l), b_base, tuple(dia_asm_l),
                      tuple(dia_sh_l),
                      tuple(pair_names), tuple(Ks), tuple(pair_of),
                      tuple(contrib_m), b_m, b_sources, tuple(tier_kb_l),
                      tuple(dia_offsets_l), tuple(res_k_l),
                      tuple(dia_asm_m_l), tuple(dia_sh_m_l))


def _edge_blocks(problem, lin):
    """Per edge group: J_s^T (rho' Omega) J_t blocks and b blocks, all via
    elementwise batched products (no tiny-dot einsums)."""
    blocks = {}
    bvecs = {}
    for eg in problem.static.egroups:
        ea = problem.edges[eg.key]
        resid, jacs, w = lin[eg.key]
        w_omega = w[:, None, None] * ea.information
        k = eg.etype.num_vertices
        jw = [bmm_small(jnp.swapaxes(jacs[s], 1, 2), w_omega)
              for s in range(k)]                       # [E, Ds, D]
        for s in range(k):
            bvecs[(eg.key, s)] = -bmv_small(jw[s], resid)
            for t in range(k):
                blocks[(eg.key, s, t)] = bmm_small(jw[s], jacs[t])
    return blocks, bvecs


def _pair_stream(problem, pattern, blocks, pid, Dr, Dc):
    """Lane-major contribution stream [Dr*Dc, E_total] of one pair table."""
    srcs = [key for key, p in pattern.pair_of if p == pid]
    return jnp.concatenate(
        [blocks[key].reshape(-1, Dr * Dc).T for key in srcs], axis=1)


def _assemble_pair(problem, pattern, blocks, pid):
    """One pair table's assembled values [Dr*Dc, N, K] (assemble_ell body)."""
    dt = problem.dtype
    rg_name, cg_name = pattern.pairs[pid]
    K = pattern.K[pid]
    rg = problem.static.vgroup(rg_name)
    cg = problem.static.vgroup(cg_name)
    Dr, Dc = rg.tangent_dim, cg.tangent_dim
    if (pattern.contrib_base[pid] is not None
            and pattern.contrib_base[pid][1] is None):
        # single-contribution-per-slot fast path: one gathered element
        # per slot instead of the [N*K, M] table. Multi-contribution
        # patterns stay on the gather table below (a scatter-ADD overflow
        # variant measured slower on the previous accelerator; not yet
        # re-measured on the H100).
        (bidx, bmask), _ = pattern.contrib_base[pid]
        stream = _pair_stream(problem, pattern, blocks, pid, Dr, Dc)
        v = jnp.take(stream, bidx, axis=1) * bmask.astype(dt)[None]
        return v.reshape(Dr * Dc, rg.count, K)
    if pattern.contrib_idx[pid] is not None:
        stream = _pair_stream(problem, pattern, blocks, pid, Dr, Dc)
        g = jnp.take(stream, pattern.contrib_idx[pid].reshape(-1), axis=1)
        g = g.reshape(Dr * Dc, rg.count * K, pattern.contrib_m[pid])
        v = (g * pattern.contrib_mask[pid].astype(dt)[None]).sum(axis=2)
        return v.reshape(Dr * Dc, rg.count, K)
    srcs = [key for key, p in pattern.pair_of if p == pid]
    v = jnp.zeros((rg.count, K, Dr, Dc), dtype=dt)
    for key in srcs:
        egkey, s, t = key
        ea = problem.edges[egkey]
        v = v.at[ea.indices[s], pattern.positions[key]].add(blocks[key])
    return jnp.moveaxis(v.reshape(rg.count, K, Dr * Dc), 2, 0)


def assemble_ell(problem, pattern: EllPattern, lin: dict):
    """Accumulate per-edge J^T W J blocks into the lane-major ELL tables.

    Returns (values: tuple of [Dr*Dc, N, K], b: dict group -> [N, D]).
    Gather + masked-sum against the host-precomputed contributor tables —
    no scatter anywhere (scatter fallback only past _CONTRIB_TABLE_LIMIT).
    """
    dt = problem.dtype
    blocks, bvecs = _edge_blocks(problem, lin)

    values = [_assemble_pair(problem, pattern, blocks, pid)
              for pid in range(len(pattern.pairs))]
    return tuple(values), _assemble_b(problem, pattern, bvecs)


def _assemble_b(problem, pattern: EllPattern, bvecs, skip=()):
    """Gradient accumulation b = -J^T W r per vertex group (row-major).
    Groups in `skip` were accumulated by the folded self-plane gather
    (assemble_hot) and are omitted here."""
    dt = problem.dtype
    b = {}
    for g in problem.static.vgroups:
        if g.name in skip:
            continue
        D = g.tangent_dim
        srcs = pattern.b_sources.get(g.name, ())
        if not srcs:
            b[g.name] = jnp.zeros((g.count, D), dtype=dt)
            continue
        if (pattern.b_base.get(g.name) is not None
                and pattern.b_base[g.name][1] is None):
            (bidx, bmask), _ = pattern.b_base[g.name]
            stream = jnp.concatenate([bvecs[key].T for key in srcs], axis=1)
            bsum = jnp.take(stream, bidx, axis=1) * bmask.astype(dt)[None]
            b[g.name] = bsum.T
        elif pattern.b_idx[g.name] is not None:
            stream = jnp.concatenate([bvecs[key].T for key in srcs], axis=1)
            gt = jnp.take(stream, pattern.b_idx[g.name].reshape(-1), axis=1)
            gt = gt.reshape(D, g.count, pattern.b_m[g.name])
            bsum = (gt * pattern.b_mask[g.name].astype(dt)[None]).sum(axis=2)
            b[g.name] = bsum.T
        else:
            acc = jnp.zeros((g.count, D), dtype=dt)
            for (egkey, s) in srcs:
                ea = problem.edges[egkey]
                acc = acc.at[ea.indices[s]].add(bvecs[(egkey, s)])
            b[g.name] = acc
    return b


def ell_add_diag(problem, pattern: EllPattern, values, extra: dict):
    """Fold a per-vertex scalar diagonal term into the ELL values.

    extra: dict group -> [N] added to every diagonal component of vertex n's
    self block (LM damping lam*free + unit diagonal on fixed slots). One
    [Dr*Dc, N, K]-sized add per trial replaces an extra multiply+add on the
    solution vector in EVERY matvec of the latency-bound PCG loop.
    """
    out = []
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        v = values[pid]
        if rg_name != cg_name or pattern.self_mask[pid] is None:
            out.append(v)
            continue
        rg = problem.static.vgroup(rg_name)
        D = rg.tangent_dim
        eye_flat = jnp.reshape(jnp.eye(D, dtype=v.dtype), (-1,))
        add = pattern.self_mask[pid].astype(v.dtype) \
            * extra[rg_name][:, None]                       # [N, K]
        out.append(v + eye_flat[:, None, None] * add[None])
    return tuple(out)


def ell_scale_jacobi(problem, pattern: EllPattern, values, linv: dict):
    """Symmetrically scale the block Hessian by the inverse Cholesky factors
    of its (damped) diagonal blocks: block(i, j) -> Linv_i block Linv_j^T.

    This is the split form of block-Jacobi preconditioning: the scaled
    system has UNIT diagonal blocks and identical CG convergence to the
    M = diag preconditioned iteration, but the per-iteration preconditioner
    apply (and the separate r.z reduction) vanish from the latency-bound hot
    loop — the scaling is two small-contraction sweeps over the values
    tables once per LM trial.

    linv: dict group -> [N, D, D] lower-triangular inverse factors.
    """
    out = []
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        K = pattern.K[pid]
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        B = values[pid].reshape(Dr, Dc, rg.count, K)
        Li = jnp.moveaxis(linv[rg_name], 0, -1)         # [Dr, Dr, N]
        # C[a, c, n, k] = sum_b Li[a, b, n] B[b, c, n, k]
        C = (Li[:, :, None, :, None] * B[None]).sum(axis=1)
        LjT = jnp.moveaxis(linv[cg_name], 0, -1)        # [Dc, Dc, Ncol]
        Ljg = jnp.take(LjT.reshape(Dc * Dc, cg.count),
                       pattern.nb_idx[pid].reshape(-1), axis=1)
        Ljg = Ljg.reshape(Dc, Dc, rg.count, K)
        # out[a, d, n, k] = sum_c C[a, c, n, k] Linv_j[d, c, n, k]
        S = (C[:, None] * Ljg[None]).sum(axis=2)
        out.append(S.reshape(Dr * Dc, rg.count, K))
    return tuple(out)


def ell_gershgorin_bound(problem, pattern: EllPattern, values,
                         kmajor: bool = False):
    """Upper bound on lambda_max of the block-ELL matrix: the Gershgorin
    row bound max_row sum_col |H[row, col]| computed directly on the
    lane-major value tables (3 ops per pair table, no matvec).

    Used to bracket the spectrum of the Jacobi-scaled system for the
    Chebyshev polynomial preconditioner: the bound is SAFE (never below the
    true lambda_max), so the Chebyshev polynomial stays positive on the
    whole spectrum and the preconditioner stays SPD.

    kmajor: values are [Dr*Dc, K, N] tables (the hot-loop layout) instead
    of [Dr*Dc, N, K].
    """
    rowsum = {g.name: jnp.zeros((g.tangent_dim, g.count),
                                dtype=problem.dtype)
              for g in problem.static.vgroups}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        if kmajor:
            V = values[pid].reshape(Dr, Dc, pattern.K[pid], rg.count)
            rowsum[rg_name] = rowsum[rg_name] + jnp.abs(V).sum(axis=(1, 2))
        else:
            V = values[pid].reshape(Dr, Dc, rg.count, pattern.K[pid])
            rowsum[rg_name] = rowsum[rg_name] + jnp.abs(V).sum(axis=(1, 3))
    hi = jnp.zeros((), problem.dtype)
    for name, rs in rowsum.items():
        hi = jnp.maximum(hi, jnp.max(rs))
    return jnp.maximum(hi, jnp.asarray(1e-3, problem.dtype))


def ell_add_diag_kmajor(problem, pattern: EllPattern, values_k, extra: dict,
                        self_maskT=None):
    """K-major form of ell_add_diag: fold a per-vertex scalar diagonal term
    into [Dr*Dc, K, N] value tables (N on lanes).

    self_maskT: optional tuple of [K, N] transposed self masks (pass from
    outside the trial loop to avoid re-transposing per trial)."""
    out = []
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        v = values_k[pid]
        if rg_name != cg_name or pattern.self_mask[pid] is None:
            out.append(v)
            continue
        rg = problem.static.vgroup(rg_name)
        D = rg.tangent_dim
        eye_flat = jnp.reshape(jnp.eye(D, dtype=v.dtype), (-1,))
        sm = (self_maskT[pid] if self_maskT is not None
              else pattern.self_mask[pid].T)
        add = sm.astype(v.dtype) * extra[rg_name][None, :]      # [K, N]
        out.append(v + eye_flat[:, None, None] * add[None])
    return tuple(out)


def ell_scale_jacobi_kmajor(problem, pattern: EllPattern, values_k,
                            linv: dict, nbT=None):
    """K-major form of ell_scale_jacobi: block(i, j) -> Linv_i B Linv_j^T on
    [Dr*Dc, K, N] tables. Every intermediate keeps N on the lane axis (the
    [.., N, K] form pads K to 128 lanes and relayouts per reshape).

    linv: dict group -> [N, D, D]; nbT: optional [K, N] neighbor tables."""
    out = []
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        K = pattern.K[pid]
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        B = values_k[pid].reshape(Dr, Dc, K, rg.count)
        Li = jnp.moveaxis(linv[rg_name], 0, -1)         # [Dr, Dr, N]
        # C[a, c, k, n] = sum_b Li[a, b, n] B[b, c, k, n]
        C = (Li[:, :, None, None, :] * B[None]).sum(axis=1)
        LjT = jnp.moveaxis(linv[cg_name], 0, -1)        # [Dc, Dc, Ncol]
        idx = nbT[pid] if nbT is not None else pattern.nb_idx[pid].T
        Ljg = jnp.take(LjT.reshape(Dc * Dc, cg.count), idx.reshape(-1),
                       axis=1)
        Ljg = Ljg.reshape(Dc, Dc, K, rg.count)          # [d, c, K, N]
        # out[a, d, k, n] = sum_c C[a, c, k, n] Linv_j[d, c, k, n]
        S = (C[:, None] * Ljg[None]).sum(axis=2)
        out.append(S.reshape(Dr * Dc, K, rg.count))
    return tuple(out)


def lane_block_mv(mats_lane: dict, xT: dict, transpose: bool = False):
    """y[a, n] = sum_b M[a, b, n] x[b, n] per group (transpose: M^T x) —
    the [D, D, N] lane-major batched block application."""
    out = {}
    for name, M in mats_lane.items():
        if transpose:
            out[name] = (M * xT[name][:, None, :]).sum(axis=0)
        else:
            out[name] = (M * xT[name][None]).sum(axis=1)
    return out


def ell_matvec_lane(problem, pattern: EllPattern, values, xT: dict,
                    extra_diagT: dict = None):
    """y = H x entirely in lane-major form: xT/yT are dicts group -> [D, N].

    The PCG hot loop holds every vector lane-major so the matvec is one lane
    gather + elementwise multiply-reduce per pair table with NO transposes per
    iteration (transposing [N, D] parts in and out of each matvec costs more
    ops than the matvec itself at pose-graph scale).

    extra_diagT: optional dict group -> [D, N] (or broadcastable [1, N])
    added elementwise (damping + fixed-slot identity), fused here.
    """
    yT = {g.name: jnp.zeros((g.tangent_dim, g.count), dtype=problem.dtype)
          for g in problem.static.vgroups}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        K = pattern.K[pid]
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        xg = jnp.take(xT[cg_name], pattern.nb_idx[pid].reshape(-1), axis=1)
        xg = xg.reshape(Dc, rg.count, K)                 # lane gather
        V = values[pid].reshape(Dr, Dc, rg.count, K)
        yT[rg_name] = yT[rg_name] + (V * xg[None]).sum(axis=(1, 3))
    if extra_diagT is not None:
        yT = {k: yT[k] + extra_diagT[k] * xT[k] for k in yT}
    return yT


def ell_values_to_kmajor(problem, pattern: EllPattern, values):
    """Re-lay the ELL value tables [Dr*Dc, N, K] -> [Dr*Dc, K, N].

    In the [.., N, K] form the tiny neighbor axis K (~4-16 on pose graphs)
    sits on the minor axis, where tiled layouts pad it. With N minor every
    hot-loop array is densely laid out. One transpose per LM trial, outside
    the CG while_loop.
    """
    out = []
    for pid in range(len(pattern.pairs)):
        out.append(jnp.swapaxes(values[pid], 1, 2))     # [Dr*Dc, K, N]
    return tuple(out)


def ell_matvec_lane_kmajor(problem, pattern: EllPattern, values_k, xT: dict,
                           nbT=None):
    """y = H x with K-major value tables ([Dr*Dc, K, N], N on lanes).

    The gather runs along lanes with a [K, N] index table whose flat
    (k-major) order matches the reshape split [Dc, K*N] -> [Dc, K, N], so
    no relayout is introduced; the contraction is a dense multiply +
    (Dc, K)-axis reduce over N-lane tiles. This is the PCG hot-loop matvec.

    nbT: optional precomputed tuple of [K, N] transposed neighbor tables
    (pass from outside the loop to avoid re-transposing per iteration).
    """
    yT = {g.name: jnp.zeros((g.tangent_dim, g.count), dtype=problem.dtype)
          for g in problem.static.vgroups}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        K = pattern.K[pid]
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        idx = nbT[pid] if nbT is not None else pattern.nb_idx[pid].T
        xg = jnp.take(xT[cg_name], idx.reshape(-1), axis=1)
        xg = xg.reshape(Dc, K, rg.count)                 # [Dc, K, N]
        V = values_k[pid].reshape(Dr, Dc, K, rg.count)
        yT[rg_name] = yT[rg_name] + (V * xg[None]).sum(axis=(1, 2))
    return yT


def ell_split_tiers_kmajor(problem, pattern: EllPattern, values_k):
    """Split K-major value tables into (base, overflow) tier operands:
    per pair, (lo [Dr*Dc, Kb, N], hi [Dr*Dc, K-Kb, N_hi] or None). The hi
    slice+column-gather is tiny (overflow rows only) and runs once per LM
    trial, outside the CG loop."""
    out = []
    for pid in range(len(pattern.pairs)):
        v = values_k[pid]
        kb = pattern.tier_kb[pid]
        rows = pattern.tier_rows[pid]
        if rows is None:
            out.append((v, None))
            continue
        lo = v[:, :kb, :]
        hi = jnp.take(v[:, kb:, :], rows, axis=2)
        out.append((lo, hi))
    return tuple(out)


def ell_matvec_lane_kmajor_tiered(problem, pattern: EllPattern, tiers,
                                  xT: dict):
    """y = H x on two-tier K-major tables (ell_split_tiers_kmajor output).

    The base tier is the standard dense [Dr*Dc, Kb, N] gather+reduce; the
    overflow tier gathers only its N_hi rows' extra neighbors and
    scatter-adds its [Dr, N_hi] result into y (unique row ids — a tiny
    scatter, far cheaper than the padding it avoids; see EllPattern tier_*
    docstring for the gather-throughput rationale)."""
    yT = {g.name: jnp.zeros((g.tangent_dim, g.count), dtype=problem.dtype)
          for g in problem.static.vgroups}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        lo, hi = tiers[pid]
        kb = pattern.tier_kb[pid]
        if hi is None:
            idx = pattern.nb_idx[pid].T
            xg = jnp.take(xT[cg_name], idx.reshape(-1), axis=1)
            V = lo.reshape(Dr, Dc, -1, rg.count)
            yT[rg_name] = yT[rg_name] + (
                V * xg.reshape(Dc, -1, rg.count)[None]).sum(axis=(1, 2))
            continue
        idx_lo = pattern.tier_lo_nbT[pid]
        xg = jnp.take(xT[cg_name], idx_lo.reshape(-1), axis=1)
        V = lo.reshape(Dr, Dc, kb, rg.count)
        yT[rg_name] = yT[rg_name] + (
            V * xg.reshape(Dc, kb, rg.count)[None]).sum(axis=(1, 2))
        rows = pattern.tier_rows[pid]
        idx_hi = pattern.tier_hi_nbT[pid]
        n_hi = idx_hi.shape[1]
        xg_hi = jnp.take(xT[cg_name], idx_hi.reshape(-1), axis=1)
        Vh = hi.reshape(Dr, Dc, -1, n_hi)
        y_hi = (Vh * xg_hi.reshape(Dc, -1, n_hi)[None]).sum(axis=(1, 2))
        yT[rg_name] = yT[rg_name].at[:, rows].add(y_hi)
    return yT


def ell_split_hot_kmajor(problem, pattern: EllPattern, values_k):
    """Per-trial split of the K-major value tables into the hot-loop
    operands, choosing per pair between the DIA band form and the
    base+overflow tier form (host decision recorded in pattern.dia_offsets).

    Returns a tuple of per-pair entries:
      ("dia", V_dia [Dr*Dc, m, N], V_res [Dr*Dc, K_res, N] or None)
      ("tier", lo, hi)   — the ell_split_tiers_kmajor operands
    """
    out = []
    for pid in range(len(pattern.pairs)):
        v = values_k[pid]
        if pattern.dia_offsets[pid] is not None:
            src = pattern.dia_src[pid]
            Vd = jnp.take_along_axis(v, src[None], axis=1) \
                * pattern.dia_mask[pid][None].astype(v.dtype)
            Vr = None
            if pattern.res_k[pid]:
                Vr = jnp.take_along_axis(v, pattern.res_srcT[pid][None],
                                         axis=1) \
                    * pattern.res_maskT[pid][None].astype(v.dtype)
            out.append(("dia", Vd, Vr))
            continue
        kb = pattern.tier_kb[pid]
        rows = pattern.tier_rows[pid]
        if rows is None:
            out.append(("tier", v, None))
        else:
            out.append(("tier", v[:, :kb, :],
                        jnp.take(v[:, kb:, :], rows, axis=2)))
    return tuple(out)


def assemble_hot(problem, pattern: EllPattern, lin: dict):
    """Assemble per-edge J^T W J blocks DIRECTLY into the hot-loop
    representation (round 5): pairs with DIA-direct tables (dia_asm) emit
    ("dia", V_dia [Dr*Dc, m, N], V_res [Dr*Dc, K_res, N]) straight from
    per-destination-class contributor gathers — no [N, K] intermediate, no
    per-trial kmajor transpose, no take_along_axis re-lay, and the self
    plane's M is the vertex degree while off-diagonal planes gather one
    element per slot. Other pairs fall back to the proven contributor-table
    assembly, returned K-major as ("k", values_k [Dr*Dc, K, N], None).

    Returns (hot: tuple of tagged entries, b: dict group -> [N, D]).
    """
    dt = problem.dtype
    blocks, bvecs = _edge_blocks(problem, lin)
    hot = []
    b_folded = {}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        asm = pattern.dia_asm[pid]
        if asm is None:
            v = _assemble_pair(problem, pattern, blocks, pid)
            hot.append(("k", jnp.swapaxes(v, 1, 2), None))
            continue
        s_idx, s_mask, o_idx, o_mask, r_idx, r_mask = asm
        Ms, Mo, Mr, m_off, has_self = pattern.dia_asm_m[pid]
        N = rg.count
        stream = _pair_stream(problem, pattern, blocks, pid, Dr, Dc)
        stream_b = None
        if has_self:
            # fold the GRADIENT accumulation into the self-plane path:
            # b's contributor set for this group is exactly the (s, s)
            # incidence set — appending the b rows to the stream at the
            # diagonal segments makes the self gather AND the self-plane
            # stream shifts serve both (round 5: the separate b gather
            # measured 2.9 ms of the 100k trial)
            srcs = [key for key, p in pattern.pair_of if p == pid]
            bseg = [jnp.swapaxes(bvecs[(k, s)], 0, 1) if s == t
                    else jnp.zeros((Dr, blocks[(k, s, t)].shape[0]),
                                   dtype=dt)
                    for (k, s, t) in srcs]
            stream_b = jnp.concatenate(
                [stream, jnp.concatenate(bseg, axis=1)], axis=0)
        # stream-shift contributions (pattern.dia_sh): pure static slices
        # of the stream, masked to the conforming rows — zero gathers
        sh_adds = {}
        b_sh = None
        if pattern.dia_sh_meta[pid]:
            for mask, (j, neg_c, use_b) in zip(pattern.dia_sh[pid],
                                               pattern.dia_sh_meta[pid]):
                src = stream_b if use_b else stream
                sl = jax.lax.slice_in_dim(src, neg_c, neg_c + N, axis=1) \
                    * mask[None].astype(dt)
                sh_adds[j] = sh_adds.get(j, 0.0) + sl[:Dr * Dc]
                if use_b:
                    b_sh = (0.0 if b_sh is None else b_sh) + sl[Dr * Dc:]
        planes = []
        if has_self:
            g = jnp.take(stream_b, s_idx.reshape(-1), axis=1)
            g = (g.reshape(Dr * Dc + Dr, Ms, N)
                 * s_mask.astype(dt)[None]).sum(axis=1)
            sval = g[:Dr * Dc] + sh_adds.get(0, 0.0)
            planes.append(sval[:, None])
            bacc = g[Dr * Dc:]
            if b_sh is not None:
                bacc = bacc + b_sh
            b_folded[rg_name] = bacc.T                 # [N, Dr]
        if m_off:
            if o_idx is None:
                p2 = jnp.zeros((Dr * Dc, m_off, N), dtype=dt)
            else:
                g = jnp.take(stream, o_idx.reshape(-1), axis=1)
                g = g.reshape(Dr * Dc, Mo, m_off, N)
                p2 = (g * o_mask.astype(dt).reshape(
                    1, Mo, m_off, N)).sum(axis=1)
            base_j = 1 if has_self else 0
            for j_off in range(m_off):
                if base_j + j_off in sh_adds:
                    p2 = p2.at[:, j_off].add(sh_adds[base_j + j_off])
            planes.append(p2)
        V_dia = jnp.concatenate(planes, axis=1) if len(planes) > 1 \
            else planes[0]
        V_res = None
        if r_idx is not None:
            kr = pattern.res_k[pid]
            g = jnp.take(stream, r_idx.reshape(-1), axis=1)
            g = g.reshape(Dr * Dc, Mr, kr, N)
            V_res = (g * r_mask.astype(dt).reshape(1, Mr, kr, N)).sum(axis=1)
        hot.append(("dia", V_dia, V_res))
    b = _assemble_b(problem, pattern, bvecs, skip=b_folded)
    b.update(b_folded)
    return tuple(hot), b


def hot_diag_blocks(problem, pattern: EllPattern, hot):
    """[N, D, D] diagonal blocks per group from assemble_hot output: DIA
    pairs read plane 0 (the self plane, build invariant — zero on rows
    without a self slot via the assembly mask); K-major pairs locate the
    self slot as pattern.diag_blocks does."""
    out = {}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        if rg_name != cg_name:
            continue
        g = problem.static.vgroup(rg_name)
        D = g.tangent_dim
        kind, a, _ = hot[pid]
        if kind == "dia":
            blk = jnp.moveaxis(a[:, 0], 0, 1).reshape(g.count, D, D)
            out[rg_name] = blk
            continue
        nb = pattern.nb_idx[pid]
        rows = jnp.arange(g.count, dtype=jnp.int32)
        is_self = nb == rows[:, None]
        slot = jnp.argmax(is_self, axis=1)
        blk = jnp.take_along_axis(a, slot[None, None, :], axis=1)[:, 0]
        blk = jnp.moveaxis(blk, 0, 1).reshape(g.count, D, D)
        out[rg_name] = blk * jnp.any(is_self, axis=1)[:, None, None]
    for g in problem.static.vgroups:
        if g.name not in out:
            out[g.name] = jnp.zeros(
                (g.count, g.tangent_dim, g.tangent_dim), dtype=problem.dtype)
    return out


def hot_add_diag(problem, pattern: EllPattern, hot, extra: dict,
                 self_maskT=None):
    """Fold a per-vertex scalar diagonal term (LM damping + fixed-slot
    identity) into assemble_hot output: DIA pairs add to plane 0 only
    (a static-index update, no scatter); K-major pairs use the transposed
    self mask as ell_add_diag_kmajor does."""
    out = []
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        kind, a, b = hot[pid]
        if rg_name != cg_name:
            out.append(hot[pid])
            continue
        rg = problem.static.vgroup(rg_name)
        D = rg.tangent_dim
        eye_flat = jnp.reshape(jnp.eye(D, dtype=a.dtype), (-1,))
        if kind == "dia":
            # self-slot presence = plane 0 of the band mask (NOT the
            # contributor table's first row — stream shifts may have
            # drained the table while the slot still exists)
            present = pattern.dia_mask[pid][0]          # [N]
            add = extra[rg_name] * present.astype(a.dtype)
            out.append(("dia",
                        a.at[:, 0, :].add(eye_flat[:, None] * add[None]), b))
        else:
            sm = (self_maskT[pid] if self_maskT is not None
                  else pattern.self_mask[pid].T)
            add = sm.astype(a.dtype) * extra[rg_name][None, :]
            out.append(("k", a + eye_flat[:, None, None] * add[None], b))
    return tuple(out)


def hot_scale_jacobi(problem, pattern: EllPattern, hot, linv: dict,
                     nbT=None):
    """Symmetric block-Jacobi scaling block(i, j) -> Linv_i B Linv_j^T on
    assemble_hot output. For DIA planes the column factor Linv_{i+d} is a
    STATIC SHIFT of the factor table (no gather — same trick as the hot
    matvec); residual and K-major slots gather factors by neighbor index
    as ell_scale_jacobi_kmajor does."""
    out = []
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        kind, a, b = hot[pid]
        Li = jnp.moveaxis(linv[rg_name], 0, -1)          # [Dr, Dr, N]
        LjT_flat = jnp.moveaxis(linv[cg_name], 0, -1).reshape(
            Dc * Dc, cg.count)
        if kind == "dia":
            m = a.shape[1]
            B = a.reshape(Dr, Dc, m, rg.count)
            C = (Li[:, :, None, None, :] * B[None]).sum(axis=1)
            Ljs = _shift_stack(LjT_flat, pattern.dia_offsets[pid],
                               rg.count).reshape(Dc, Dc, m, rg.count)
            Vd = (C[:, None] * Ljs[None]).sum(axis=2).reshape(
                Dr * Dc, m, rg.count)
            Vr = None
            if b is not None:
                kr = b.shape[1]
                Br = b.reshape(Dr, Dc, kr, rg.count)
                Cr = (Li[:, :, None, None, :] * Br[None]).sum(axis=1)
                Ljg = jnp.take(LjT_flat, pattern.res_nbT[pid].reshape(-1),
                               axis=1).reshape(Dc, Dc, kr, rg.count)
                Vr = (Cr[:, None] * Ljg[None]).sum(axis=2).reshape(
                    Dr * Dc, kr, rg.count)
            out.append(("dia", Vd, Vr))
        else:
            K = pattern.K[pid]
            B = a.reshape(Dr, Dc, K, rg.count)
            C = (Li[:, :, None, None, :] * B[None]).sum(axis=1)
            idx = nbT[pid] if nbT is not None else pattern.nb_idx[pid].T
            Ljg = jnp.take(LjT_flat, idx.reshape(-1), axis=1).reshape(
                Dc, Dc, K, rg.count)
            S = (C[:, None] * Ljg[None]).sum(axis=2)
            out.append(("k", S.reshape(Dr * Dc, K, rg.count), b))
    return tuple(out)


def hot_split(problem, pattern: EllPattern, hot):
    """assemble_hot/hot_scale_jacobi output -> ell_matvec_lane_kmajor_hot
    operands: DIA entries pass through (already in hot form); K-major
    entries get the two-tier base+overflow split."""
    out = []
    for pid in range(len(pattern.pairs)):
        kind, a, b = hot[pid]
        if kind == "dia":
            out.append(("dia", a, b))
            continue
        kb = pattern.tier_kb[pid]
        rows = pattern.tier_rows[pid]
        if rows is None:
            out.append(("tier", a, None))
        else:
            out.append(("tier", a[:, :kb, :],
                        jnp.take(a[:, kb:, :], rows, axis=2)))
    return tuple(out)


def hot_gershgorin_bound(problem, pattern: EllPattern, hot):
    """Gershgorin lambda_max bound on assemble_hot/hot_scale_jacobi output
    (the Chebyshev bracket, see ell_gershgorin_bound)."""
    rowsum = {g.name: jnp.zeros((g.tangent_dim, g.count),
                                dtype=problem.dtype)
              for g in problem.static.vgroups}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        kind, a, b = hot[pid]
        V = jnp.abs(a).reshape(Dr, Dc, -1, rg.count).sum(axis=(1, 2))
        rowsum[rg_name] = rowsum[rg_name] + V
        if kind == "dia" and b is not None:
            Vr = jnp.abs(b).reshape(Dr, Dc, -1, rg.count).sum(axis=(1, 2))
            rowsum[rg_name] = rowsum[rg_name] + Vr
    hi = jnp.zeros((), problem.dtype)
    for rs in rowsum.values():
        hi = jnp.maximum(hi, jnp.max(rs))
    return jnp.maximum(hi, jnp.asarray(1e-3, problem.dtype))


def _shift_stack(x, offsets, n_rows):
    """[Dc, m, n_rows] stack of statically-shifted copies of x [Dc, N_c]:
    entry (j, i) = x[:, i + offsets[j]] (zero outside range). Pure
    pad+slice — no gathers."""
    n_cols = x.shape[1]
    cols = []
    for d in offsets:
        lo = max(0, -d)
        hi = min(n_rows, n_cols - d)
        if hi <= lo:
            cols.append(jnp.zeros((x.shape[0], n_rows), dtype=x.dtype))
            continue
        sl = jax.lax.slice_in_dim(x, lo + d, hi + d, axis=1)
        cols.append(jnp.pad(sl, ((0, 0), (lo, n_rows - hi))))
    return jnp.stack(cols, axis=1)


def ell_matvec_lane_kmajor_hot(problem, pattern: EllPattern, split, xT: dict):
    """y = H x on ell_split_hot_kmajor operands: DIA pairs consume
    SHIFTED dense copies of x (no gather) plus a small
    residual gather; tier pairs run the proven base+overflow gathers."""
    yT = {g.name: jnp.zeros((g.tangent_dim, g.count), dtype=problem.dtype)
          for g in problem.static.vgroups}
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        kind, a, b = split[pid]
        if kind == "dia":
            xs = _shift_stack(xT[cg_name], pattern.dia_offsets[pid],
                              rg.count)                   # [Dc, m, N]
            V = a.reshape(Dr, Dc, -1, rg.count)
            yT[rg_name] = yT[rg_name] + (V * xs[None]).sum(axis=(1, 2))
            if b is not None:
                idx = pattern.res_nbT[pid]
                xg = jnp.take(xT[cg_name], idx.reshape(-1), axis=1)
                Vr = b.reshape(Dr, Dc, -1, rg.count)
                yT[rg_name] = yT[rg_name] + (
                    Vr * xg.reshape(Dc, -1, rg.count)[None]).sum(axis=(1, 2))
            continue
        lo, hi = a, b
        if hi is None:
            idx = pattern.nb_idx[pid].T
            xg = jnp.take(xT[cg_name], idx.reshape(-1), axis=1)
            V = lo.reshape(Dr, Dc, -1, rg.count)
            yT[rg_name] = yT[rg_name] + (
                V * xg.reshape(Dc, -1, rg.count)[None]).sum(axis=(1, 2))
            continue
        kb = pattern.tier_kb[pid]
        idx_lo = pattern.tier_lo_nbT[pid]
        xg = jnp.take(xT[cg_name], idx_lo.reshape(-1), axis=1)
        V = lo.reshape(Dr, Dc, kb, rg.count)
        yT[rg_name] = yT[rg_name] + (
            V * xg.reshape(Dc, kb, rg.count)[None]).sum(axis=(1, 2))
        rows = pattern.tier_rows[pid]
        idx_hi = pattern.tier_hi_nbT[pid]
        n_hi = idx_hi.shape[1]
        xg_hi = jnp.take(xT[cg_name], idx_hi.reshape(-1), axis=1)
        Vh = hi.reshape(Dr, Dc, -1, n_hi)
        y_hi = (Vh * xg_hi.reshape(Dc, -1, n_hi)[None]).sum(axis=(1, 2))
        yT[rg_name] = yT[rg_name].at[:, rows].add(y_hi)
    return yT


def ell_matvec(problem, pattern: EllPattern, values, x: dict,
               extra_diag: dict = None):
    """y = H x on row-major per-group part dicts (group -> [N, D]).

    Wrapper over ell_matvec_lane for callers holding row-major parts; the
    PCG hot loop uses the lane-major form directly to skip the per-call
    transposes.
    """
    xT = {name: v.T for name, v in x.items()}           # [D, N], lane-major
    yT = ell_matvec_lane(problem, pattern, values, xT)
    y = {name: v.T for name, v in yT.items()}
    if extra_diag is not None:
        y = {k: y[k] + extra_diag[k] * x[k] for k in y}
    return y
