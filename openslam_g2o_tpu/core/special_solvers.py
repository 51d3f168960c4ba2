"""Special-purpose solvers: structure-only BA and the linear 2D initializer.

JAX re-designs of g2o/solvers/structure_only
(structure_only_solver.h:40-200) and g2o/solvers/slam2d_linear
(solver_slam2d_linear.cpp:84-215, Carlone et al. RSS'11).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from openslam_g2o_tpu.core.graph import Graph
from openslam_g2o_tpu.core import problem as P
from openslam_g2o_tpu.core.algorithms import (
    GaussNewton, LevenbergMarquardt, optimize)
from openslam_g2o_tpu.core.hyper_dijkstra import shortest_paths, visit_tree
from openslam_g2o_tpu.core.solvers import solve_dense_cholesky
from openslam_g2o_tpu.utils import np_lie

__all__ = ["structure_only_optimize", "solve_orientation_linear",
           "SolverSlam2DLinear", "StructureOnly"]


# ---------------------------------------------------------------------------
# structure_only
# ---------------------------------------------------------------------------

def structure_only_optimize(problem: P.Problem, iterations: int = 10):
    """Optimize only the marginalizable (landmark) vertices with everything
    else held fixed.

    The reference runs an independent LM per landmark
    (structure_only_solver.h:40-200, deliberately 'misusing' the API); here
    the landmark blocks are independent by construction (block-diagonal
    Hessian), so one batched LM over the masked problem IS per-landmark LM —
    every landmark gets its own 3x3 solve inside the batched Cholesky.
    Returns (problem with updated landmark params, stats).
    """
    masked_free = {}
    for g in problem.static.vgroups:
        if g.vtype.marginalizable:
            masked_free[g.name] = problem.free[g.name]
        else:
            masked_free[g.name] = jnp.zeros_like(problem.free[g.name])
    masked = dataclasses.replace(problem, free=masked_free)
    out, stats = optimize(masked, LevenbergMarquardt(), iterations=iterations)
    return dataclasses.replace(out, free=problem.free), stats


class StructureOnly:
    """Algorithm-API wrapper for the factory (structure_only_2/_3,
    structure_only.cpp:62-65)."""

    name = "structure_only"

    def __init__(self, **kw):
        pass

    def init(self, prob):
        return {"params": prob.params}

    def step(self, prob, state):
        work = prob.with_params(state["params"])
        out, stats = structure_only_optimize(work, iterations=1)
        return {"params": out.params}, stats[-1]


# ---------------------------------------------------------------------------
# slam2d_linear
# ---------------------------------------------------------------------------

def solve_orientation_linear(graph: Graph):
    """Carlone linear orientation estimation for 2D pose graphs
    (solver_slam2d_linear.cpp:92-215):

    1. spanning-tree theta guess from the fixed root,
    2. one linear least squares over wrapped orientation residuals,
    3. poses reset to (0, 0, theta) — the subsequent Gauss-Newton solves the
       (now linear) translation problem.

    Modifies the graph estimates in place. Returns the theta vector.
    """
    se2_edges = [e for e in graph.edges if e.etype.name == "edge_se2"]
    ids = sorted(graph.vertices)
    idx = {vid: i for i, vid in enumerate(ids)}
    n = len(ids)

    fixed = [vid for vid in ids if graph.vertices[vid].fixed]
    if len(fixed) != 1:
        raise ValueError(
            f"slam2d_linear requires exactly one fixed vertex, got {len(fixed)}")
    root = fixed[0]

    # 1. spanning-tree guess
    theta_guess = np.zeros(n)
    tree = shortest_paths(graph, root,
                          edge_filter=lambda e: e.etype.name == "edge_se2")

    def set_theta(vid, parent, edge):
        if parent is None:
            theta_guess[idx[vid]] = graph.vertices[vid].params[2]
            return
        dtheta = edge.measurement[2]
        if edge.vertex_ids[0] == parent:
            theta_guess[idx[vid]] = np_lie.normalize_angle(
                theta_guess[idx[parent]] + dtheta)
        else:
            theta_guess[idx[vid]] = np_lie.normalize_angle(
                theta_guess[idx[parent]] - dtheta)

    visit_tree(tree, set_theta)

    # 2. linear least squares over wrapped residuals
    free_mask = np.array([0.0 if graph.vertices[v].fixed else 1.0 for v in ids])
    H = np.zeros((n, n))
    b = np.zeros(n)
    for e in se2_edges:
        i, j = idx[e.vertex_ids[0]], idx[e.vertex_ids[1]]
        omega = e.information[2, 2]
        err = np_lie.normalize_angle(
            -e.measurement[2] + theta_guess[j] - theta_guess[i])
        omega_r = -omega * err
        if free_mask[i]:
            b[i] -= omega_r
            H[i, i] += omega
            if free_mask[j]:
                H[i, j] -= omega
                H[j, i] -= omega
        if free_mask[j]:
            b[j] += omega_r
            H[j, j] += omega
    H += np.diag(1.0 - free_mask)

    x, ok = solve_dense_cholesky(jnp.asarray(H), jnp.asarray(b))
    if not bool(ok):
        raise RuntimeError("orientation linear solve failed")
    x = np.asarray(x) * free_mask
    thetas = np_lie.normalize_angle(theta_guess + x)

    # 3. reset poses to (0, 0, theta); root to origin
    for vid in ids:
        rec = graph.vertices[vid]
        if vid == root:
            rec.params = np.zeros(3)
        else:
            rec.params = np.array([0.0, 0.0, thetas[idx[vid]]])
    return thetas


class SolverSlam2DLinear:
    """'2dlinear' algorithm (slam2d_linear.cpp:77-79): linear orientation
    init on the first step, then standard Gauss-Newton. Construct it, call
    prepare(graph) before compiling, then use as a normal algorithm."""

    name = "2dlinear"

    def __init__(self, **kw):
        self._gn = GaussNewton()

    def prepare(self, graph: Graph):
        solve_orientation_linear(graph)

    def init(self, prob):
        return self._gn.init(prob)

    def step(self, prob, state):
        return self._gn.step(prob, state)
