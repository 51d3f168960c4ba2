"""Online / incremental optimization.

A re-design of the interactive_slam engine
(g2o_interactive/graph_optimizer_sparse_online.h:37 SparseOptimizerOnline,
g2o_incremental/graph_optimizer_sparse_incremental.h:30
SparseOptimizerIncremental). The reference's incremental solver patches a
CHOLMOD factor with rank updates (cholmod_updown,
linear_solver_cholmod_online.h:135-160) because a CPU re-factorization is
expensive. On an accelerator a full re-linearize + solve is a single fused
device program, and the cost to avoid is recompilation when array shapes
change. So the design is:

* array shapes are padded to power-of-two buckets -> O(log N) compilations
  over the whole session, everything else hits the jit cache,
* the device tables are maintained INCREMENTALLY in capacity-doubling numpy
  buffers (append = one row write); each SOLVE slices the current bucket and
  ships it — no per-vertex Python restacking, so the host cost per solve is
  O(padding memset + transfer), not O(N) object traversal,
* each SOLVE is a warm start from the current estimates (the reference's
  online variant also re-solves from the current state),
* new vertices are initialized from their first edge via the spanning-tree
  rule (initialEstimate), matching G2OSlamInterface::addEdge
  (g2o_slam_interface.cpp).

Vertices/edges are append-only (exactly the reference protocol's ADD
vocabulary, g2o_interactive/protocol.txt); use the batch Graph API for
graph surgery.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from openslam_g2o_tpu.core.graph import Graph
from openslam_g2o_tpu.core import problem as P
from openslam_g2o_tpu.core import registry, robust
from openslam_g2o_tpu.core.algorithms import GaussNewton, optimize

__all__ = ["OnlineOptimizer", "bucket_pow2"]

_robust_chi2_jit = None


def _jitted_robust_chi2():
    """Module-cached jit of robust_chi2 (a fresh jax.jit wrapper per call
    would retrace every solve)."""
    global _robust_chi2_jit
    if _robust_chi2_jit is None:
        import jax
        _robust_chi2_jit = jax.jit(P.robust_chi2)
    return _robust_chi2_jit


def bucket_pow2(n: int, minimum: int = 64) -> int:
    """Next power-of-two bucket (>= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


class _VGroupBuf:
    """Capacity-doubling vertex table for one type."""

    def __init__(self, vt: registry.VertexType, cap: int):
        self.vt = vt
        self.n = 0
        self.origin = np.asarray(vt.origin(np.float64), dtype=np.float64)
        self.params = np.empty((cap, vt.ambient_dim))
        self.free = np.empty((cap,))

    def _grow(self, cap):
        if cap <= len(self.params):
            return
        self.params = np.concatenate(
            [self.params, np.empty((cap - len(self.params),
                                    self.params.shape[1]))])
        self.free = np.concatenate(
            [self.free, np.empty((cap - len(self.free),))])

    def append(self, params, fixed: bool) -> int:
        i = self.n
        self._grow(bucket_pow2(i + 1, len(self.params)))
        self.params[i] = params
        self.free[i] = 0.0 if fixed else 1.0
        self.n += 1
        return i


class _EGroupBuf:
    """Capacity-doubling edge table for one (type, kernel) group."""

    def __init__(self, et: registry.EdgeType, kernel_id: int, cap: int):
        self.et = et
        self.kernel_id = kernel_id
        self.n = 0
        k = et.num_vertices
        self.idx = [np.empty((cap,), dtype=np.int32) for _ in range(k)]
        self.meas = np.empty((cap, et.measurement_dim))
        self.info = np.empty((cap, et.error_dim, et.error_dim))
        self.delta = np.empty((cap,))
        self.pdata = [None] * len(et.param_types)   # lazily sized

    def _grow(self, cap):
        if cap <= len(self.meas):
            return
        extra = cap - len(self.meas)
        self.idx = [np.concatenate([c, np.empty((extra,), dtype=np.int32)])
                    for c in self.idx]
        self.meas = np.concatenate(
            [self.meas, np.empty((extra, self.meas.shape[1]))])
        self.info = np.concatenate(
            [self.info, np.empty((extra,) + self.info.shape[1:])])
        self.delta = np.concatenate([self.delta, np.empty((extra,))])
        self.pdata = [None if p is None else np.concatenate(
            [p, np.empty((extra, p.shape[1]))]) for p in self.pdata]

    def append(self, local_idx, meas, info, delta, pdata_rows) -> int:
        i = self.n
        self._grow(bucket_pow2(i + 1, len(self.meas)))
        for s, li in enumerate(local_idx):
            self.idx[s][i] = li
        self.meas[i] = meas
        self.info[i] = info
        self.delta[i] = delta
        for ps, row in enumerate(pdata_rows):
            if self.pdata[ps] is None:
                self.pdata[ps] = np.empty((len(self.meas), len(row)))
            self.pdata[ps][i] = row
        self.n += 1
        return i


class OnlineOptimizer:
    """Incrementally growing graph with warm-started re-solves.

    Usage (mirrors G2OSlamInterface, g2o_slam_interface.h:49-57):
        oo.add_vertex(id, "se2", params_or_None)
        oo.add_edge("edge_se2", (i, j), meas, info)
        oo.fix(id)
        oo.solve()            # a few warm-started iterations
        oo.estimate(id)
    """

    def __init__(self, algorithm=None, iterations_per_solve: int = 3,
                 dtype=None, bucket=bucket_pow2, persistent_cache=True):
        if persistent_cache:
            # each new shape bucket compiles the solve program; the
            # persistent cache lets later sessions reuse those executables
            # (utils/compile_cache.py)
            from openslam_g2o_tpu.utils.compile_cache import (
                enable_persistent_cache)
            enable_persistent_cache()
        self._graph = Graph()
        self.algorithm = algorithm or GaussNewton()
        self.iterations = iterations_per_solve
        self.dtype = dtype
        self.bucket = bucket
        self._vbufs: dict[str, _VGroupBuf] = {}
        self._ebufs: dict[str, _EGroupBuf] = {}
        self._local: dict[int, tuple] = {}      # vid -> (group name, row)
        self._graph_dirty = False
        self._solves = 0
        self._last_static = None
        self._compiles = 0
        # fast-path LM state carried across solves (device scalars — never
        # synced to host): lambda/nu warm-start the next solve's trial loop
        self._warm_lam = None
        self._warm_ni = None

    # -- graph views --------------------------------------------------------

    @property
    def graph(self) -> Graph:
        """The host Graph, with estimates synced from the device tables."""
        self._sync_graph()
        return self._graph

    def _sync_graph(self):
        if not self._graph_dirty:
            return
        for vid, (gname, i) in self._local.items():
            # copy: the buffer row may be reallocated on growth
            self._graph.vertices[vid].params = self._vbufs[gname].params[i].copy()
        self._graph_dirty = False

    # -- graph construction ------------------------------------------------

    def add_vertex(self, vid: int, type_name: str, params=None):
        vt = registry.vertex_type(type_name)
        buf = self._vbufs.get(type_name)
        if buf is None:
            buf = self._vbufs[type_name] = _VGroupBuf(vt, 64)
        if params is None:
            params = buf.origin      # cached host copy — no device op
        rec = self._graph.add_vertex(vid, type_name, params)
        self._local[vid] = (type_name, buf.append(rec.params, rec.fixed))
        return rec

    def _params_of(self, vid: int) -> np.ndarray:
        gname, i = self._local[vid]
        return self._vbufs[gname].params[i]

    def _set_params(self, vid: int, value):
        gname, i = self._local[vid]
        self._vbufs[gname].params[i] = value
        self._graph.vertices[vid].params = self._vbufs[gname].params[i].copy()

    def add_edge(self, type_name: str, vertex_ids, measurement, information,
                 **kw):
        """Add an edge; endpoints that exist but were never initialized are
        re-initialized from the edge measurement when possible (the
        G2OSlamInterface behavior: odometry edges chain the trajectory)."""
        et = registry.edge_type(type_name)
        rec = self._graph.add_edge(type_name, vertex_ids, measurement,
                                   information, **kw)
        if et.initial_estimate is not None and et.num_vertices == 2:
            v0p = self._params_of(vertex_ids[0])
            v1p = self._params_of(vertex_ids[1])
            # cached HOST origins (the buffers hold one per type): calling
            # vt.origin() here would dispatch a device op per added edge
            origin1 = self._vbufs[self._local[vertex_ids[1]][0]].origin
            origin0 = self._vbufs[self._local[vertex_ids[0]][0]].origin
            if np.array_equal(v1p, origin1) and not np.array_equal(
                    v0p, origin0):
                import jax
                # chain-init math is a handful of eager ops on one vertex:
                # run it on the host CPU backend so that ADD never waits on
                # an accelerator dispatch and transfer
                with jax.default_device(jax.devices("cpu")[0]):
                    est = et.initial_estimate(
                        (v0p, v1p), rec.measurement,
                        tuple(self._graph.parameters[p][1]
                              for p in rec.param_ids),
                        1)
                if est is not None:
                    self._set_params(vertex_ids[1], np.asarray(est))
        kid = robust.kernel_id(rec.kernel)
        key = type_name if kid == robust.NONE_ID \
            else f"{type_name}#{robust.kernel_names()[kid]}"
        buf = self._ebufs.get(key)
        if buf is None:
            buf = self._ebufs[key] = _EGroupBuf(et, kid, 64)
        buf.append([self._local[v][1] for v in rec.vertex_ids],
                   rec.measurement, rec.information, rec.kernel_delta,
                   [self._graph.parameters[p][1] for p in rec.param_ids])
        return rec

    def add_parameter(self, pid: int, type_name: str, value):
        self._graph.add_parameter(pid, type_name, value)

    def fix(self, vid: int):
        self._graph.set_fixed(vid, True)
        gname, i = self._local[vid]
        self._vbufs[gname].free[i] = 0.0

    # -- device problem from the incremental buffers ------------------------

    def _build_problem(self) -> P.Problem:
        import jax.numpy as jnp

        dtype = self.dtype
        if dtype is None:
            dtype = jnp.result_type(float)     # float64 iff x64 is on
        # poses-first group order (buildIndexMapping invariant,
        # sparse_optimizer.cpp:166-190), stable in first-seen order
        names = sorted(self._vbufs, key=lambda n: self._vbufs[n].vt.marginalizable)
        vgroups = []
        params = {}
        free = {}
        offset = 0
        pose_dim = 0
        for name in names:
            buf = self._vbufs[name]
            cap = self.bucket(buf.n)
            buf._grow(cap)
            # padding rows: fixed at the origin, so they contribute nothing
            buf.params[buf.n:cap] = buf.origin
            buf.free[buf.n:cap] = 0.0
            params[name] = jnp.asarray(buf.params[:cap], dtype=dtype)
            free[name] = jnp.asarray(buf.free[:cap], dtype=dtype)
            vgroups.append(P.VGroup(name, buf.vt, cap, offset))
            offset += cap * buf.vt.tangent_dim
            if not buf.vt.marginalizable:
                pose_dim = offset
        egroups = []
        edges = {}
        for key, buf in self._ebufs.items():
            cap = self.bucket(buf.n)
            buf._grow(cap)
            # padding edges: zero information, measurement/pdata repeat row 0
            # (a VALID row keeps error kernels finite — problem.py semantics)
            buf.meas[buf.n:cap] = buf.meas[0]
            buf.info[buf.n:cap] = 0.0
            buf.delta[buf.n:cap] = 1.0
            for c in buf.idx:
                c[buf.n:cap] = 0
            pdata = []
            for p in buf.pdata:
                p[buf.n:cap] = p[0]
                pdata.append(jnp.asarray(p[:cap], dtype=dtype))
            edges[key] = P.EdgeArrays(
                tuple(jnp.asarray(c[:cap]) for c in buf.idx),
                jnp.asarray(buf.meas[:cap], dtype=dtype),
                jnp.asarray(buf.info[:cap], dtype=dtype),
                jnp.asarray(buf.delta[:cap], dtype=dtype),
                tuple(pdata))
            egroups.append(P.EGroup(key, buf.et, buf.kernel_id, cap))
        static = P.ProblemStatic(tuple(vgroups), tuple(egroups), offset,
                                 pose_dim if pose_dim else offset)
        return P.Problem(params, free, edges, static)

    # -- solving -----------------------------------------------------------

    def solve(self, iterations: Optional[int] = None,
              want_stats: bool = True):
        """Re-linearize and run a few iterations, warm-started from the
        current estimates; result lands back in the incremental tables.

        Fast path: when the algorithm is pattern-based (LevenbergMarquardtPCG
        — the incremental configuration), the block-ELL pattern is
        rebuilt host-side per solve with the zero-information bucket padding
        masked OUT of the neighbor/contributor tables
        (sparse.build_ell_pattern(edge_valid=...)); the device solve then
        runs the same lane-major ELL-PCG step as the batch path, so a solve
        costs milliseconds instead of the dense path's seconds. jit entries
        are keyed on the (bucketed) shapes + the pattern's K/M paddings, so
        a long-running session converges to a handful of compiles."""
        if not self._ebufs:
            return []
        if not any(buf.free[:buf.n].min() == 0.0
                   for buf in self._vbufs.values() if buf.n):
            self.fix(next(iter(self._graph.vertices)))
        if getattr(self.algorithm, "name", "") == "lm_pcg":
            return self._solve_fast(iterations, want_stats)
        prob = self._build_problem()
        if prob.static != self._last_static:
            self._compiles += 1
            self._last_static = prob.static
        out, stats = optimize(prob, self.algorithm,
                              iterations=iterations or self.iterations)
        for name, buf in self._vbufs.items():
            buf.params[:buf.n] = np.asarray(out.params[name])[:buf.n]
        self._graph_dirty = True
        self._solves += 1
        return stats

    def _solve_fast(self, iterations, want_stats=True):
        """The pattern-based LM-PCG solve: build the padded problem and its
        padding-masked ELL pattern on the host, then run the whole solve as
        ONE device program (lax.scan over LM steps, chi0 computed inside)
        followed by one result fetch."""
        import jax.numpy as jnp
        from openslam_g2o_tpu.core.sparse import build_ell_pattern
        from openslam_g2o_tpu.core.algorithms import (
            _lambda_init_pcg, lm_pcg_optimize_fused)

        a = self.algorithm
        prob = self._build_problem()
        valid = {key: np.arange(prob.edges[key].measurement.shape[0])
                 < self._ebufs[key].n for key in self._ebufs}
        pattern = build_ell_pattern(prob, edge_valid=valid)
        if prob.static != self._last_static:
            self._compiles += 1
            self._last_static = prob.static
        self.algorithm.use_pattern(prob, pattern)
        if self._warm_lam is None:
            # honor a user-supplied initialLambda exactly like the batch
            # driver (LevenbergMarquardtPCG.init); tau-init otherwise
            if getattr(a, "initial_lambda", 0.0) > 0:
                self._warm_lam = jnp.asarray(a.initial_lambda, prob.dtype)
            else:
                self._warm_lam = _lambda_init_pcg(
                    prob, pattern, prob.params,
                    jnp.asarray(a.tau, prob.dtype))
            self._warm_ni = jnp.asarray(2.0, prob.dtype)
        params, lam, ni, chi, traj = lm_pcg_optimize_fused(
            prob, pattern, prob.params, self._warm_lam, self._warm_ni, None,
            n_iters=iterations or self.iterations, max_trials=a.max_trials,
            pcg_iters=a.pcg_iters, pcg_tol=a.pcg_tol, pcg_cheby=a.pcg_cheby)
        self._warm_lam, self._warm_ni = lam, ni
        for name, buf in self._vbufs.items():
            buf.params[:buf.n] = np.asarray(params[name])[:buf.n]
        self._graph_dirty = True
        self._solves += 1
        if not want_stats:
            return []
        return [{"chi2": float(c)} for c in np.asarray(traj)]

    # -- queries -----------------------------------------------------------

    def estimate(self, vid: int):
        return self._params_of(vid)

    def estimates(self, vids=None):
        if vids is None:
            vids = sorted(self._graph.vertices)
        return {vid: self._params_of(vid) for vid in vids}

    def session_stats(self):
        """Throughput counters (the incremental perf evidence the reference
        carries in its stats output, graph_optimizer_sparse_incremental.cpp)."""
        return {"solves": self._solves,
                "shape_buckets_compiled": self._compiles,
                "vertices": len(self._local),
                "edges": sum(b.n for b in self._ebufs.values())}
