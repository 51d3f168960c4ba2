"""Smoke test of the optimizer's main path on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths

Each phase drives a user entry point (`optimize`, the CLI, OnlineOptimizer
and the protocol server) at a size its users run, on the card, and compares
the result with a plain reference computed in float64 on the host CPU. All
data comes from the repo's seeded generators. Every phase runs in this one
process (a JAX process reserves most of the card's memory, so a second one
would fail for want of it); the CLI is called as `cli.main(argv)` and the
protocol server reads an in-memory stdin.

The run fails (non-zero exit, no result line) when JAX finds no GPU, and
when any phase misses its gate. The last line of a passing run is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Times printed here are smoke timings of one run, not benchmark numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".cache", "smoke")
F32 = jnp.float32

# LM stops early once the device chi2 is this far inside a 1.02 gate, so the
# float64 re-evaluation (which can differ from the float32 sum in its last
# digits) still has margin
_STOP_MARGIN = 0.995


# -- helpers ----------------------------------------------------------------

@contextlib.contextmanager
def host_f64():
    """Scope for the plain references: float64 on the host CPU."""
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        yield


def to_f64(tree):
    """Host float64 copy of a pytree (call inside host_f64)."""
    cpu = jax.devices("cpu")[0]

    def conv(x):
        a = np.asarray(x)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float64)
        return jax.device_put(a, cpu)
    return jax.tree_util.tree_map(conv, tree)


def chi2_f64(prob, params) -> float:
    """chi2 of `params` on `prob`, evaluated in float64 on the host."""
    from openslam_g2o_tpu.core import problem as P
    with host_f64():
        return float(P.chi2(to_f64(prob).with_params(to_f64(params))))


def peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def step_times(stats):
    """(first call incl. compile, median of the later calls) in seconds."""
    times = [s["time"] for s in stats]
    return times[0], (statistics.median(times[1:]) if len(times) > 1
                      else None)


def stop_below(limit):
    """post_iteration callback for optimize(): stop once chi2 <= limit."""
    return lambda it, state: float(state["chi2"]) <= limit


def result(size, gate, value, limit, first_s, steady_s, **extra):
    return dict(size=size, gate=gate, value=float(value), limit=limit,
                ok=bool(np.isfinite(value) and value <= limit),
                first_call_s=first_s, steady_s=steady_s, **extra)


def expected_ba_chi2(n_obs, n_cams, n_points, pixel_noise=1.0):
    """Noise-floor chi2 of the synthetic BAL scenes: residual dof times the
    injected pixel variance, (2E - dof) sigma^2 with dof = 6(C-1) + 3P."""
    return (2.0 * n_obs - (6 * (n_cams - 1) + 3 * n_points)) \
        * pixel_noise ** 2


def _dense_damped_step(prob, lam):
    """Reference LM step: the float64 dense damped system
    (H + lam diag(free)) dx = b, factored by Cholesky on the host."""
    import scipy.linalg as sla
    from openslam_g2o_tpu.core import problem as P
    with host_f64():
        p64 = to_f64(prob)
        H, b, _ = P.build_dense_system(p64)
        free_t, _ = P.tangent_masks(p64)
        Hd = np.asarray(H) + float(lam) * np.diag(np.asarray(free_t))
        return sla.cho_solve(sla.cho_factor(Hd), np.asarray(b))


def _flat(prob, partsT):
    """Lane-major per-group parts {name: [D, N]} -> flat tangent vector."""
    return np.concatenate([np.asarray(partsT[g.name], np.float64).T.ravel()
                           for g in prob.static.vgroups])


# -- phases -----------------------------------------------------------------

def pose_graph_100k(n_poses=100000, grid=100):
    """The DIA/hot LM-PCG path on the serpentine pose graph, through
    optimize(): inexact steps to 1.05x the noise floor, then tight-tolerance
    steps. Gate: chi2 of the solution, re-evaluated in host float64, within
    1.02x the analytic noise floor."""
    from openslam_g2o_tpu.apps.simulator import synthetic_pose_graph_2d
    from openslam_g2o_tpu.core.algorithms import (
        LevenbergMarquardtPCG, optimize)

    prob, info = synthetic_pose_graph_2d(n_poses=n_poses, grid=grid,
                                         trans_noise=0.03, rot_noise=0.002,
                                         dtype=F32)
    floor = info["noise_floor_chi2"]
    t0 = time.monotonic()
    out, stats = optimize(prob, LevenbergMarquardtPCG(pcg_iters=100,
                                                      pcg_tol=0.15),
                          iterations=300,
                          post_iteration=stop_below(1.05 * floor))
    out, stats2 = optimize(out, LevenbergMarquardtPCG(pcg_iters=600,
                                                      pcg_tol=1e-6),
                           iterations=200,
                           post_iteration=stop_below(
                               _STOP_MARGIN * 1.02 * floor))
    wall = time.monotonic() - t0
    first, steady = step_times(stats)
    return result(f"{n_poses} poses, {info['n_edges']} edges",
                  "chi2_f64 / noise floor", chi2_f64(prob, out.params) / floor,
                  1.02, first, steady, lm_iters=len(stats) + len(stats2),
                  total_s=wall)


def pcg_step_exact(n_poses=2000, grid=20, tol=1e-3):
    """One LM-PCG step (3x3 SE2 blocks, tight CG tolerance) against the
    float64 dense Cholesky solve of the same damped system. Tolerance: the
    float32 CG stops at a 1e-6 relative preconditioned residual; through the
    damped system's conditioning that leaves ~1e-4 relative error in dx, so
    1e-3 passes a correct solve and fails any assembly or layout fault."""
    from openslam_g2o_tpu.apps.simulator import synthetic_pose_graph_2d
    from openslam_g2o_tpu.core.algorithms import (
        LevenbergMarquardtPCG, _lm_pcg_step)

    prob, _ = synthetic_pose_graph_2d(n_poses=n_poses, grid=grid,
                                      trans_noise=0.03, rot_noise=0.002,
                                      dtype=F32)
    algo = LevenbergMarquardtPCG(pcg_iters=4000, pcg_tol=1e-6)
    st = algo.init(prob)
    pattern = algo.pattern(prob)
    times = []
    for _ in range(2):
        t0 = time.monotonic()
        out = _lm_pcg_step(prob, pattern, st["params"], st["lam"], st["ni"],
                           st["chi2"], pcg_iters=algo.pcg_iters,
                           pcg_tol=algo.pcg_tol)
        jax.block_until_ready(out)
        times.append(time.monotonic() - t0)
    trials, dxT = int(out[4]), out[6]
    if trials != 1 or not bool(out[5]):
        raise RuntimeError(f"first trial not accepted ({trials} trials)")
    dx_ref = _dense_damped_step(prob, st["lam"])
    dx = _flat(prob, dxT)
    err = np.linalg.norm(dx - dx_ref) / np.linalg.norm(dx_ref)
    return result(f"{n_poses} poses, {3 * n_poses} unknowns",
                  "||dx - dx_ref|| / ||dx_ref||", err, tol, times[0],
                  times[1])


def _ba(n_cams, n_points, obs_per_point, route, pcg_iters, pcg_tol,
        iterations):
    from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem
    from openslam_g2o_tpu.core.algorithms import optimize
    from openslam_g2o_tpu.core.ba_ell import (
        LevenbergMarquardtSchurELL, dense_schur_ok)

    prob, gt = synthetic_bal_problem(n_cams=n_cams, n_points=n_points,
                                     obs_per_point=obs_per_point, dtype=F32)
    algo = LevenbergMarquardtSchurELL(pcg_iters=pcg_iters, pcg_tol=pcg_tol)
    taken = "dense" if dense_schur_ok(prob, algo.pattern(prob)) \
        else "implicit"
    if taken != route:
        raise RuntimeError(f"expected the {route} Schur route, got {taken}")
    exp = expected_ba_chi2(gt["n_obs"], n_cams, n_points)
    t0 = time.monotonic()
    out, stats = optimize(prob, algo, iterations=iterations,
                          post_iteration=stop_below(
                              _STOP_MARGIN * 1.02 * exp))
    wall = time.monotonic() - t0
    first, steady = step_times(stats)
    return result(f"{n_cams} cams, {n_points} points, {gt['n_obs']} obs, "
                  f"{taken} Schur", "chi2_f64 / noise floor",
                  chi2_f64(prob, out.params) / exp, 1.02, first, steady,
                  lm_iters=len(stats), total_s=wall)


def ba_80k(n_cams=100, n_points=10000, obs_per_point=8, route="dense"):
    """Schur BA through optimize(LevenbergMarquardtSchurELL) on the dense
    reduced-camera-system route. Gate: float64 chi2 within 1.02x the noise
    floor."""
    return _ba(n_cams, n_points, obs_per_point, route, pcg_iters=30,
               pcg_tol=0.05, iterations=60)


def ba_400k(n_cams=900, n_points=50000, obs_per_point=8, route="implicit"):
    """Schur BA on the implicit matrix-free route (single-table K-chunk
    scans). Gate: float64 chi2 within 1.02x the noise floor."""
    return _ba(n_cams, n_points, obs_per_point, route, pcg_iters=50,
               pcg_tol=1e-2, iterations=40)


def schur_step_exact(n_cams=20, n_points=500, obs_per_point=6, tol=1e-3):
    """One Schur LM solve (reduced camera system + landmark
    back-substitution) against the float64 dense Cholesky solve of the full
    damped system. Tolerance: float32 elimination through a system whose
    damped condition number is ~1e4 leaves ~1e-4 relative error in dx."""
    from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem
    from openslam_g2o_tpu.core.ba_ell import (
        LevenbergMarquardtSchurELL, _build, _solve, dense_schur_ok)
    from openslam_g2o_tpu.core.problem import linearize

    prob, gt = synthetic_bal_problem(n_cams=n_cams, n_points=n_points,
                                     obs_per_point=obs_per_point, dtype=F32)
    algo = LevenbergMarquardtSchurELL(pcg_iters=500, pcg_tol=1e-7)
    lam = algo.init(prob)["lam"]
    pattern = algo.pattern(prob)

    @jax.jit
    def solve(prob, pattern, lam):
        sys_ = _build(prob, pattern, linearize(prob))
        return _solve(prob, pattern, sys_, lam, algo.pcg_iters,
                      pcg_tol=algo.pcg_tol)[:2]

    times = []
    for _ in range(2):
        t0 = time.monotonic()
        dxT, ok = jax.block_until_ready(solve(prob, pattern, lam))
        times.append(time.monotonic() - t0)
    if not bool(ok):
        raise RuntimeError("Schur solve reported failure")
    dx_ref = _dense_damped_step(prob, lam)

    def err(dxT):
        dx = _flat(prob, dxT)
        return np.linalg.norm(dx - dx_ref) / np.linalg.norm(dx_ref)
    # diagnostic: the same solve with EVERY matmul at HIGHEST; the gate
    # value should match it if the solver's own precision settings cover
    # every site that reduced precision would reach
    with jax.default_matmul_precision("highest"):
        err_highest = err(solve(prob, pattern, lam)[0])
    route = "dense" if dense_schur_ok(prob, pattern) else "implicit"
    return result(f"{n_cams} cams, {n_points} points, {gt['n_obs']} obs, "
                  f"{route} Schur", "||dx - dx_ref|| / ||dx_ref||",
                  err(dxT), tol, times[0], times[1],
                  err_all_matmuls_highest=err_highest)


def marginals_80k(n_cams=100, n_points=10000, obs_per_point=8, tol=5e-3):
    """compute_marginals_schur on the BA scene, spot-checked against an
    independent host float64 assembly of the reduced system (scatter of the
    per-landmark W blocks into a dense S, numpy inverse). The check shares
    the route's own linearization products (a second float32 evaluation of
    the 8e4-term reductions differs by ~sqrt(E) eps, which S^-1 amplifies),
    so it measures what the route adds: densify, assembly and recovery.
    Tolerance 5e-3: float32 recovery through cond(S) ~ 1e9 after Jacobi
    equilibration measures ~1e-4; a real assembly fault is O(1)."""
    import dataclasses
    from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem
    from openslam_g2o_tpu.core import ba_ell as BE
    from openslam_g2o_tpu.core.marginals import (
        _gather_w_flat, compute_marginals_schur)
    from openslam_g2o_tpu.core.problem import linearize

    prob, gt = synthetic_bal_problem(n_cams=n_cams, n_points=n_points,
                                     obs_per_point=obs_per_point, dtype=F32)
    # pin a second camera: monocular BA has a 7-dof gauge and cam 0 pins
    # only 6; the free scale mode would make the covariances meaningless
    Tp = prob.static.pose_dim
    cg = [g for g in prob.static.vgroups if g.offset < Tp][0]
    free = dict(prob.free)
    free[cg.name] = free[cg.name].at[1].set(0.0)
    prob = dataclasses.replace(prob, free=free)
    pattern = BE.build_ba_ell_pattern(prob)
    with jax.default_matmul_precision("highest"):
        lin = jax.jit(linearize)(prob)
        sys_ = jax.jit(lambda p, l: BE._build(p, pattern, l))(prob, lin)
    times = []
    for _ in range(2):
        t0 = time.monotonic()
        cov = jax.block_until_ready(
            compute_marginals_schur(prob, pattern, lin=lin, sys=sys_))
        times.append(time.monotonic() - t0)

    lg = prob.static.vgroup(pattern.lm_name)
    dl, L, Dp, C = lg.tangent_dim, lg.count, cg.tangent_dim, cg.count
    pg = pattern.proj[0]
    W = np.asarray(_gather_w_flat(prob, lin, pg), np.float64)  # [L,K,Dp,dl]
    free_l = np.asarray(prob.free[lg.name], np.float64)
    Hll = np.moveaxis(np.asarray(sys_["Hll"], np.float64), -1, 0)
    Hinv = np.linalg.inv(Hll + (1.0 - free_l)[:, None, None] * np.eye(dl))
    f = np.asarray(prob.free[cg.name], np.float64)
    Hcc = np.moveaxis(np.asarray(sys_["groups"][cg.name]["Hcc"], np.float64),
                      -1, 0)
    Hcc = Hcc * f[:, None, None] + (1.0 - f)[:, None, None] * np.eye(Dp)
    S = np.zeros((Tp, Tp))
    gidx = np.arange(C)[:, None] * Dp + np.arange(Dp)[None, :]
    S[gidx[:, :, None], gidx[:, None, :]] += Hcc
    lm_cam = np.asarray(pg.lm_cam)                              # [L, K]
    pairs = np.einsum("lkst,ltu,lmvu->lkmsv", W, Hinv, W)
    rows = (lm_cam[:, :, None] * Dp)[..., None, None] \
        + np.arange(Dp)[None, None, None, :, None]
    cols = (lm_cam[:, None, :] * Dp)[..., None, None] \
        + np.arange(Dp)[None, None, None, None, :]
    np.add.at(S, (np.broadcast_to(rows, pairs.shape).ravel(),
                  np.broadcast_to(cols, pairs.shape).ravel()), -pairs.ravel())
    Sinv = np.linalg.inv(S)

    def rel(got, want):
        return float(np.abs(np.asarray(got) - want).max()
                     / max(np.abs(want).max(), 1e-12))

    err = 0.0
    for c in np.linspace(2, C - 1, 5).astype(int):            # 0, 1 fixed
        err = max(err, rel(cov[cg.name][c],
                           Sinv[c * Dp:(c + 1) * Dp, c * Dp:(c + 1) * Dp]))
    for j in np.linspace(3, L - 1, 5).astype(int):
        cams = lm_cam[j]
        corr = sum(W[j, a].T @ Sinv[ca * Dp:(ca + 1) * Dp,
                                    cb * Dp:(cb + 1) * Dp] @ W[j, b]
                   for a, ca in enumerate(cams) for b, cb in enumerate(cams))
        err = max(err, rel(cov[pattern.lm_name][j],
                           Hinv[j] + Hinv[j] @ corr @ Hinv[j]))
    trace = float(np.trace(np.asarray(cov[cg.name][2])))
    if not trace > 0:
        raise RuntimeError(f"sampled camera covariance trace {trace}")
    return result(f"{n_cams} cams, {n_points} points, {gt['n_obs']} obs",
                  "max rel err of sampled blocks", err, tol, times[0],
                  times[1])


def _slam2d_graph(n_poses, seed):
    """A Manhattan-style grid walk with loop closures. The heading noise
    (0.005 rad per step) keeps the odometry init in a basin that LM leaves
    in ~10 iterations, so that solvers that differ in their steps can be
    compared at their common minimum."""
    from openslam_g2o_tpu.apps.simulator import Simulator2D
    g, _ = Simulator2D(seed=seed, rot_noise=0.005).simulate(
        n_poses, landmark_obs=False)
    return g


def _reference_lm_chi2(graph, iterations):
    """Batch dense LM in float64 on the host CPU: the plain reference."""
    from openslam_g2o_tpu.core.algorithms import (
        LevenbergMarquardt, TerminateCriterion, optimize)
    if graph.gauge_freedom():
        graph.set_fixed(graph.find_gauge(), True)
    with host_f64():
        prob = graph.compile(dtype=jnp.float64)
        _, stats = optimize(prob, LevenbergMarquardt(),
                            iterations=iterations,
                            terminate=TerminateCriterion(1e-9))
        return stats[-1]["chi2"]


def _graph_chi2_f64(graph) -> float:
    from openslam_g2o_tpu.core import problem as P
    with host_f64():
        return float(P.chi2(graph.compile(dtype=jnp.float64)))


def cli(n_poses=3500, iterations=20, rtol=(1e-3, 1e-6)):
    """The g2o CLI (apps/cli.py main) on a generated Manhattan-style file:
    `-solver lm_var_pcg -f32` and `-solver lm_var` (float64 dense
    Cholesky). Both final chi2 values (of the saved solution, re-evaluated
    in float64) must match the host float64 dense LM minimum: within 1e-3
    for the float32 PCG run (float32 resolves the minimum to ~1e-4 of
    chi2), within 1e-6 for the float64 run (same algorithm, only the
    summation order differs)."""
    from openslam_g2o_tpu.apps import cli as cli_app
    from openslam_g2o_tpu.io.g2o_format import load_g2o, save_g2o

    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "cli_input.g2o")
    save_g2o(_slam2d_graph(n_poses, seed=0), path)
    ref = _reference_lm_chi2(load_g2o(path), iterations)
    errs, times = [], []
    # -f32 first: the float64 run switches jax_enable_x64 on for the process
    for solver, extra in (("lm_var_pcg", ["-f32", "-solverProperties",
                                          "pcgIterations=400,"
                                          "pcgTolerance=1e-6"]),
                          ("lm_var", [])):
        out = os.path.join(WORK, f"cli_{solver}.g2o")
        stats_path = os.path.join(WORK, f"cli_{solver}.jsonl")
        argv = ["-i", str(iterations), "-solver", solver, *extra,
                "-o", out, "-stats", stats_path, path]
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_app.main(argv)
        if rc != 0:
            raise RuntimeError(f"cli {' '.join(argv)} returned {rc}")
        with open(stats_path) as fh:
            times.append(step_times([json.loads(ln) for ln in fh]))
        errs.append(abs(_graph_chi2_f64(load_g2o(out)) - ref) / ref)
    worst = max(e / t for e, t in zip(errs, rtol))
    return result(f"{n_poses} poses, {iterations} LM iterations",
                  "max(|chi2 - ref| / ref / rtol) over (f32 PCG, f64 dense)",
                  worst, 1.0, *times[0], rel_err_f32_pcg=errs[0],
                  rel_err_f64_dense=errs[1],
                  f64_dense_first_and_steady_s=times[1])


def incremental(n_poses=1000, solve_every=50, rtol=1e-3, protocol_poses=40):
    """A generated session replayed through OnlineOptimizer (ADD every
    vertex and its edges, SOLVE every `solve_every`, float32 LM-PCG), then a
    short session through the protocol server (apps/interactive.py main)
    fed from an in-memory stdin. Gate: the final estimate's float64 chi2
    within 1e-3 of the host float64 batch LM minimum of the same graph (the
    incremental solves are inexact, pcg_tol 1e-2; a closing 20-iteration
    solve brings them to the basin floor)."""
    from openslam_g2o_tpu.apps import interactive
    from openslam_g2o_tpu.core.algorithms import LevenbergMarquardtPCG
    from openslam_g2o_tpu.core.online import OnlineOptimizer

    g = _slam2d_graph(n_poses, seed=1)
    by_new = {}
    for e in g.edges:
        by_new.setdefault(max(e.vertex_ids), []).append(e)
    from openslam_g2o_tpu.core.algorithms import lm_pcg_optimize_fused
    oo = OnlineOptimizer(algorithm=LevenbergMarquardtPCG(pcg_iters=200,
                                                         pcg_tol=1e-2),
                         iterations_per_solve=2, dtype=F32)
    programs0 = lm_pcg_optimize_fused._cache_size()
    times = []
    for k, vid in enumerate(sorted(g.vertices)):
        rec = g.vertices[vid]
        oo.add_vertex(vid, rec.vtype.name, rec.params)
        if k == 0:
            oo.fix(vid)
        for e in by_new.get(vid, []):
            oo.add_edge(e.etype.name, e.vertex_ids, e.measurement,
                        e.information)
        if k > 0 and k % solve_every == 0:
            t0 = time.monotonic()
            oo.solve(want_stats=False)
            times.append(time.monotonic() - t0)
    oo.solve(iterations=20, want_stats=False)
    programs = lm_pcg_optimize_fused._cache_size() - programs0
    ref = _reference_lm_chi2(g, 40)
    value = abs(_graph_chi2_f64(oo.graph) - ref) / ref

    # protocol server: ADD/SOLVE_STATE/QUERY_STATE on the session's first
    # poses, read from an in-memory stdin
    lines = []
    for vid in range(protocol_poses):
        lines.append(f"ADD VERTEX_XYT {vid} "
                     + " ".join(repr(float(v)) for v in g.vertices[vid].params) + ";")
        for e in by_new.get(vid, []):
            info = e.information[np.triu_indices(3)]
            lines.append(f"ADD EDGE_XYT {len(lines)} {e.vertex_ids[0]} "
                         f"{e.vertex_ids[1]} "
                         + " ".join(repr(float(v)) for v in [*e.measurement, *info]) + ";")
        if vid == protocol_poses // 2:
            lines.append("SOLVE_STATE;")
    lines += ["SOLVE_STATE;", "QUERY_STATE;"]
    stdin, out = sys.stdin, io.StringIO()
    try:
        sys.stdin = io.StringIO("\n".join(lines) + "\n")
        with contextlib.redirect_stdout(out):
            interactive.main([])
    finally:
        sys.stdin = stdin
    reply = out.getvalue().split("\n")
    body = reply[reply.index("BEGIN") + 1:reply.index("END")]
    est = np.array([[float(v) for v in ln.split()[2:]] for ln in body])
    if est.shape != (protocol_poses, 3) or not np.isfinite(est).all():
        raise RuntimeError(f"QUERY_STATE returned {est.shape} estimates")
    return result(f"{n_poses} poses, {len(times) + 1} solves; protocol "
                  f"{protocol_poses} poses", "|chi2 - ref| / ref", value,
                  rtol, times[0], statistics.median(times[1:]),
                  solve_programs_compiled=programs,
                  shape_buckets=oo.session_stats()["shape_buckets_compiled"])


PHASES = [pose_graph_100k, pcg_step_exact, ba_80k, ba_400k,
          schur_step_exact, marginals_80k, incremental, cli]


# -- driver -----------------------------------------------------------------

def run_phase(fn, **kw) -> dict:
    """Run one phase; failures are reported in the result, never hidden."""
    t0 = time.monotonic()
    try:
        res = fn(**kw)
    except Exception:
        res = {"ok": False, "error": traceback.format_exc(limit=6)}
    res.update(phase=fn.__name__, wall_s=time.monotonic() - t0,
               peak_bytes_in_use=peak_bytes())
    return res


def _fmt(res) -> str:
    if "error" in res:
        return (f"phase {res['phase']}: FAILED after {res['wall_s']:.1f} s\n"
                + res["error"])
    steady = ("n/a" if res["steady_s"] is None
              else f"{res['steady_s'] * 1e3:.2f} ms")
    extra = {k: v for k, v in res.items() if k not in {
        "phase", "size", "gate", "value", "limit", "ok", "first_call_s",
        "steady_s", "wall_s", "peak_bytes_in_use"}}
    return (f"phase {res['phase']}: {'PASS' if res['ok'] else 'FAIL'} | "
            f"size {res['size']} | gate {res['gate']} = {res['value']:.6g} "
            f"(limit {res['limit']:g}) | first call incl. compile "
            f"{res['first_call_s']:.2f} s | steady {steady} per call "
            f"(smoke timing, not a benchmark) | phase wall "
            f"{res['wall_s']:.1f} s | peak_bytes_in_use "
            f"{res['peak_bytes_in_use']}"
            + (f" | {json.dumps(extra)}" if extra else ""))


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _tf32_probe() -> float:
    """Relative error of a float32 matmul at the default precision against
    HIGHEST: ~1e-7 means full float32, ~1e-3 means TF32 tensor cores."""
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.normal(ka, (512, 512), F32)
    b = jax.random.normal(kb, (512, 512), F32)
    hi = jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    return float(jnp.abs(a @ b - hi).max() / jnp.abs(hi).max())


def four_cards() -> bool:
    from __graft_entry__ import dryrun_multichip

    try:
        dryrun_multichip(4)
    except Exception:
        traceback.print_exc()
        return False
    for d in jax.devices():
        stats = d.memory_stats() or {}
        print(f"device {d.id} ({d.device_kind}): peak_bytes_in_use "
              f"{stats.get('peak_bytes_in_use')}", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the multi-device paths on four cards instead")
    args = ap.parse_args(argv)

    # the references run on the host CPU backend beside the GPU
    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r} "
              f"({dev.device_kind}); nothing was run", file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    from openslam_g2o_tpu.utils.compile_cache import enable_persistent_cache
    print(f"compile cache: {enable_persistent_cache()}")
    print(f"card: {_card_line()}")
    print(f"jax {jax.__version__}, jax_default_matmul_precision="
          f"{jax.config.jax_default_matmul_precision!r}, default f32 matmul "
          f"rel err vs HIGHEST {_tf32_probe():.2e}", flush=True)

    if args.four_cards:
        ok = four_cards()
    else:
        ok = True
        for fn in PHASES:
            res = run_phase(fn)
            print(_fmt(res), flush=True)
            ok = ok and res["ok"]
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
