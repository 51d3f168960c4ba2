"""Spanning-tree initial guess.

Host-side analogue of EstimatePropagator (g2o/core/estimate_propagator.h:51-161,
.cpp:86-267) + SparseOptimizer::computeInitialGuess
(g2o/core/sparse_optimizer.cpp:300-352): grow a Dijkstra frontier outward from
the fixed (gauge) vertices, and initialize every reached vertex from its tree
parent via the edge's `initial_estimate` rule. This is a once-per-solve graph
traversal over host numpy data — the device recompute afterwards is what
matters on the accelerator, so a Python BFS/priority queue is the right tool (the
reference also runs this single-threaded on the CPU).

Edge types opt in by providing ``initial_estimate(vparams, meas, pdata, slot)``
returning the estimate for slot `slot` given the other slots' params (the
analogue of Edge::initialEstimate, e.g. edge_se2.h initialEstimate).
"""
from __future__ import annotations

import heapq

import numpy as np

from openslam_g2o_tpu.core.graph import Graph

__all__ = ["spanning_tree_initial_guess", "odometry_cost"]


def odometry_cost(edge) -> float:
    """EstimatePropagatorCostOdometry (estimate_propagator.h:66-77,
    .cpp:249-266): prefer odometry edges when growing the spanning tree —
    an edge counts only if it is binary and joins consecutively-numbered
    vertices (the reference's "simple method to identify odometry edges in a
    pose graph"); everything else costs infinity and is never traversed."""
    if len(edge.vertex_ids) == 2 and \
            abs(edge.vertex_ids[0] - edge.vertex_ids[1]) == 1:
        return 1.0
    return np.inf


def spanning_tree_initial_guess(graph: Graph, cost_fn=None) -> int:
    """Initialize non-fixed vertex estimates along a min-cost spanning tree
    rooted at the fixed vertices. Returns the number of vertices initialized.

    `cost_fn(edge)` gives the traversal cost (default 1.0 per edge — the
    EstimatePropagatorCost edge-count metric)."""
    if cost_fn is None:
        cost_fn = lambda e: 1.0

    # adjacency: vid -> list of (edge, slot_of_vid)
    adj: dict[int, list] = {vid: [] for vid in graph.vertices}
    for e in graph.edges:
        if e.etype.initial_estimate is None:
            continue
        for s, vid in enumerate(e.vertex_ids):
            adj[vid].append((e, s))

    dist = {vid: np.inf for vid in graph.vertices}
    heap = []
    for vid, rec in graph.vertices.items():
        if rec.fixed:
            dist[vid] = 0.0
            heapq.heappush(heap, (0.0, vid))
    if not heap:
        # no fixed vertex: root at the gauge candidate
        root = graph.find_gauge()
        if root is None:
            return 0
        dist[root] = 0.0
        heapq.heappush(heap, (0.0, root))

    visited = set()
    initialized = 0
    while heap:
        d, vid = heapq.heappop(heap)
        if vid in visited:
            continue
        visited.add(vid)
        for e, s_from in adj[vid]:
            # try to initialize each *other* slot of this edge
            for s_to, wid in enumerate(e.vertex_ids):
                if s_to == s_from or wid in visited:
                    continue
                nd = d + cost_fn(e)
                if nd >= dist[wid]:
                    continue
                vparams = tuple(graph.vertices[u].params for u in e.vertex_ids)
                pdata = tuple(graph.parameters[p][1] for p in e.param_ids)
                est = e.etype.initial_estimate(vparams, e.measurement, pdata, s_to)
                if est is None:
                    continue
                rec = graph.vertices[wid]
                if not rec.fixed:
                    rec.params = np.asarray(est, dtype=np.float64).reshape(
                        rec.vtype.ambient_dim)
                    initialized += 1
                dist[wid] = nd
                heapq.heappush(heap, (nd, wid))
    return initialized
