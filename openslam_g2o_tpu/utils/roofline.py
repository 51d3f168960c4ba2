"""Roofline / MFU accounting: tie measured phase times to hardware limits.

The reference's per-phase discipline (G2OBatchStatistics,
g2o/core/batch_stats.h:40-84) records wall-clock only; on an accelerator a
time is unfalsifiable without the corresponding FLOP and byte counts, so this
module
pairs every measured kernel with an analytic cost model and reports achieved
FLOP/s and HBM bandwidth against the chip's peaks, plus the roofline-implied
ceiling min(peak_flops, AI * BW) for its arithmetic intensity.

Where the runtime exposes XLA's own accounting (Compiled.cost_analysis()),
those numbers are reported alongside for cross-checking; the analytic model
is authoritative (XLA's "bytes accessed" counts every buffer touch, not HBM
traffic).
"""
from __future__ import annotations

from dataclasses import dataclass, asdict

import jax

__all__ = ["chip_peaks", "roofline_report", "ell_pcg_iteration_cost",
           "ba_ell_step_cost", "linearize_cost"]


# Peak rates per device kind, keyed by jax's `device_kind`. Source: NVIDIA
# H100 SXM data sheet, dense rates without sparsity, at the full 700 W power
# limit (a card set below it cannot hold these clocks under load, so report
# its power limit beside any share of them). The sparse kernels here are
# elementwise and gather work, governed by memory bandwidth.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "peak_bf16_flops": 989e12,
        "peak_tf32_flops": 495e12,
        "peak_f32_flops": 67e12,      # outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}


def chip_peaks(device=None) -> dict:
    """Peak FLOP/s and HBM bandwidth for the device (first jax device by
    default). A device kind without a row is an error, never a default."""
    device = device or jax.devices()[0]
    kind = device.device_kind
    if kind not in _PEAKS:
        raise ValueError(
            f"no peak rates for device kind {kind!r}; add a row with its "
            f"source to utils/roofline._PEAKS")
    return {"device_kind": kind, **_PEAKS[kind]}


@dataclass
class PhaseCost:
    """Analytic cost of one kernel/phase: FLOPs and minimum HBM bytes."""
    label: str
    flops: float
    bytes: float


def ell_pcg_iteration_cost(problem, pattern, itemsize: int = 4) -> PhaseCost:
    """FLOPs/bytes of ONE PCG iteration on the block-ELL Hessian.

    Matvec: per pair table — 2*slots*Dr*Dc FLOPs; HBM traffic is the value
    tables (they stream every iteration) plus, for gather pairs, the
    gathered x lanes and int32 index table. DIA pairs (EllPattern dia_*)
    consume statically shifted copies of x, so their compulsory traffic is
    the value planes + residual tier only.

    Vector traffic: when any pair runs the DIA form, count one x-read + one
    y-write of the CG state as the compulsory floor. Otherwise keep the
    streaming model (small graphs are latency-bound and the distinction is
    noise there).
    """
    flops = 0.0
    bts = 0.0
    any_dia = any(getattr(pattern, "dia_offsets",
                          (None,) * len(pattern.pairs))[p] is not None
                  for p in range(len(pattern.pairs)))
    for pid, (rg_name, cg_name) in enumerate(pattern.pairs):
        rg = problem.static.vgroup(rg_name)
        cg = problem.static.vgroup(cg_name)
        K = pattern.K[pid]
        Dr, Dc = rg.tangent_dim, cg.tangent_dim
        if getattr(pattern, "dia_offsets", (None,) * (pid + 1))[pid] \
                is not None:
            m = len(pattern.dia_offsets[pid])
            kr = pattern.res_k[pid]
            slots = rg.count * (m + kr)
            flops += 2.0 * slots * Dr * Dc
            bts += rg.count * m * Dr * Dc * itemsize        # value planes
            bts += rg.count * kr * (Dr * Dc * itemsize + 4)  # res tier
            continue
        # two-tier split: count the ACTUAL gathered/processed slots
        # (base tier N*Kb + overflow tier N_hi*(K-Kb)), not the uniform
        # max-degree padding (EllPattern tier_* docstring)
        kb = pattern.tier_kb[pid]
        rows = pattern.tier_rows[pid]
        if rows is None:
            slots = rg.count * K
        else:
            slots = rg.count * kb + rows.shape[0] * (K - kb)
        flops += 2.0 * slots * Dr * Dc
        bts += slots * (Dr * Dc * itemsize          # values
                        + Dc * itemsize             # gathered x
                        + 4)                        # nb_idx int32
        bts += rg.count * Dr * itemsize             # y write
    T = sum(g.count * g.tangent_dim for g in problem.static.vgroups)
    Dsum = sum(g.count * g.tangent_dim * g.tangent_dim
               for g in problem.static.vgroups)
    flops += 2.0 * Dsum            # block-Jacobi apply
    flops += 3 * 2.0 * T           # p.Hp, r.z, r.r
    flops += 3 * 2.0 * T           # 3 axpys
    if any_dia:
        bts += 2 * T * itemsize    # x in + y out
    else:
        bts += Dsum * itemsize
        bts += 10 * T * itemsize   # vector reads/writes across the iteration
    return PhaseCost("pcg_iteration", flops, bts)


def linearize_cost(problem, itemsize: int = 4) -> PhaseCost:
    """Approximate FLOPs/bytes of linearize + J^T W J block products.

    Jacobians via jacfwd cost ~(1 + sum tangent dims) error evaluations; an
    SE2/SE3 error evaluation is a few tens of FLOPs per edge. The JtWJ
    products dominate: per edge k^2 small matmuls [Ds,d]x[d,Dt] plus the
    weighted row [d,d]x[d,Dt]."""
    flops = 0.0
    bts = 0.0
    for eg in problem.static.egroups:
        E = eg.count
        d = eg.etype.error_dim
        dims = [problem.static.vgroup(g).tangent_dim for g in eg.slots]
        tsum = sum(dims)
        flops += E * 60.0 * (1 + tsum)          # error + jacfwd passes
        for Ds in dims:
            flops += 2.0 * E * Ds * d * d       # W J_s
            for Dt in dims:
                flops += 2.0 * E * Ds * d * Dt  # J_s^T (W J_t)
        bts += E * itemsize * (d * tsum + d * d + d   # J, Omega, resid
                               + sum(Ds * Dt for Ds in dims for Dt in dims))
    return PhaseCost("linearize_jtwj", flops, bts)


def ba_ell_step_cost(problem, pattern, pcg_iters: int,
                     itemsize: int = 4) -> PhaseCost:
    """One dual-ELL Schur LM step (core/ba_ell.py).

    Models whichever solve branch the pattern routes to: the dense-Schur
    path (one-hot densify + [Tp, Tp] dense Cholesky — dominated by the
    S = B Hinv B^T matmul, 2 * Tp^2 * (dl*L) FLOPs) when the dense operand
    is present and the gates pass, else the implicit matrix-free PCG path
    (per-iteration W gathers + multiply-reduces)."""
    lin = linearize_cost(problem, itemsize)
    flops, bts = lin.flops, lin.bytes
    pose_g = [g for g in problem.static.vgroups
              if not g.vtype.marginalizable]
    lm_g = [g for g in problem.static.vgroups if g.vtype.marginalizable]
    n_obs = sum(eg.count for eg in problem.static.egroups)
    if not (lm_g and pose_g):
        return PhaseCost("ba_ell_lm_step", flops, bts)
    Dl = lm_g[0].tangent_dim
    L = lm_g[0].count
    Dp = pose_g[0].tangent_dim
    Tp = problem.static.pose_dim
    flops += L * (Dl ** 3) * 2            # Hll inverse (closed form ~2D^3)
    bts += L * Dl * Dl * itemsize * 2

    # the SAME predicate the solver's _build uses (shared helper) — the
    # cost model and the dispatcher cannot diverge on which branch runs
    from openslam_g2o_tpu.core.ba_ell import dense_schur_ok
    dense = dense_schur_ok(problem, pattern)
    if dense:
        K = pattern.proj[0].lm_edge_idx.shape[1]
        B_bytes = Tp * Dl * L * itemsize
        # densify (once per linearization) + Hinv apply + S matmul +
        # Cholesky + rhs/backsub matvecs
        flops += 2.0 * Tp * 3 * L * K          # one-hot contraction
        bts += L * K * (Tp + Dp * Dl) * itemsize + B_bytes
        if pattern.proj[0].cam_onehot is not None:
            # camera-side owner reduce as an [Dp*Dp+Dp, E] @ [E, C] matmul
            C = pose_g[0].count
            flops += 2.0 * (Dp * Dp + Dp) * n_obs * C
            bts += n_obs * C * itemsize
        flops += 2.0 * Tp * Dl * Dl * L        # HB = Hinv o B
        bts += 2.0 * B_bytes
        flops += 2.0 * Tp * Tp * (Dl * L)      # S = B @ HB^T (matmul)
        bts += 2.0 * B_bytes + Tp * Tp * itemsize
        flops += Tp ** 3 / 3.0                 # Cholesky
        bts += 3.0 * Tp * Tp * itemsize
        flops += 2 * 2.0 * Tp * Dl * L         # rhs + backsub matvecs
        bts += 2.0 * B_bytes
        return PhaseCost("ba_ell_lm_step_dense", flops, bts)
    # implicit PCG: W Hll^-1 W^T products per observation pair via the ELL
    flops += 4.0 * n_obs * Dp * Dl * (Dp + Dl)
    bts += n_obs * Dp * Dl * itemsize * 3
    flops += pcg_iters * 4.0 * n_obs * Dp * Dl
    bts += pcg_iters * n_obs * (2 * Dp * Dl * itemsize + Dp * itemsize
                                + Dl * itemsize + 8)
    return PhaseCost("ba_ell_lm_step", flops, bts)


def roofline_report(cost: PhaseCost, seconds: float, peaks: dict = None,
                    dtype_flops: str = "f32") -> dict:
    """Measured time + analytic cost -> achieved rates vs chip limits."""
    peaks = peaks or chip_peaks()
    peak_f = peaks[f"peak_{dtype_flops}_flops"]
    peak_bw = peaks["hbm_bytes_per_s"]
    ai = cost.flops / max(cost.bytes, 1.0)
    ceiling_flops = min(peak_f, ai * peak_bw)
    achieved_f = cost.flops / max(seconds, 1e-12)
    achieved_bw = cost.bytes / max(seconds, 1e-12)
    out = {
        "phase": cost.label,
        "flops": cost.flops,
        "hbm_bytes": cost.bytes,
        "seconds": seconds,
        "arithmetic_intensity": round(ai, 3),
        "achieved_gflops": round(achieved_f / 1e9, 2),
        "achieved_gbps": round(achieved_bw / 1e9, 2),
        "mfu_pct": round(100.0 * achieved_f / peak_f, 4),
        "hbm_bw_pct": round(100.0 * achieved_bw / peak_bw, 2),
        "roofline_ceiling_gflops": round(ceiling_flops / 1e9, 2),
        "pct_of_roofline": round(100.0 * achieved_f / ceiling_flops, 2),
        "bound": "hbm_bw" if ai * peak_bw < peak_f else "compute",
    }
    # falsifiability guard: achieving >100% of a hardware peak means the
    # COST MODEL mispriced the kernel — flag it as a model error rather
    # than printing an unphysical efficiency; 2% tolerance for
    # timer/clock-spec noise
    if out["hbm_bw_pct"] > 102.0 or out["mfu_pct"] > 102.0:
        out["model_error"] = (
            "achieved rate exceeds the hardware peak — the analytic "
            "cost model does not match the measured kernel; fix the "
            "PhaseCost before citing this roofline")
    return out


def xla_cost_analysis(fn, *args) -> dict:
    """XLA's own per-executable accounting, when the backend exposes it."""
    try:
        compiled = jax.jit(fn).lower(*args).compile()
        ca = compiled.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0] if ca else {}
        return {"xla_flops": ca.get("flops"),
                "xla_bytes_accessed": ca.get("bytes accessed")}
    except Exception:
        return {}
