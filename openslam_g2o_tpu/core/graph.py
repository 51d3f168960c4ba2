"""Host-side graph container.

The JAX replacement for HyperGraph/OptimizableGraph
(g2o/core/hyper_graph.h:59, g2o/core/optimizable_graph.h:65). The reference
stores heap-allocated vertex/edge objects wired by pointers; here the graph is
a plain Python-side record store whose only job is bookkeeping (ids, types,
fixed flags, parameters) — `compile()` lowers it to a struct-of-arrays
`Problem` pytree that lives on device and is what every optimizer touches.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from openslam_g2o_tpu.core import registry, robust


@dataclass
class VertexRecord:
    vid: int
    vtype: registry.VertexType
    params: np.ndarray            # [ambient_dim]
    fixed: bool = False
    marginalized: bool = False
    data: list = field(default_factory=list)  # attached payloads (types/data)


@dataclass
class EdgeRecord:
    etype: registry.EdgeType
    vertex_ids: tuple
    measurement: np.ndarray       # [measurement_dim] (internal form)
    information: np.ndarray       # [error_dim, error_dim]
    kernel: str = "None"
    kernel_delta: float = 1.0
    param_ids: tuple = ()
    level: int = 0


class Graph:
    """Mutable optimization graph (host side).

    Usage mirrors the reference's programmatic API
    (examples/tutorial_slam2d/tutorial_slam2d.cpp:23-120): add vertices with
    estimates, add edges with measurement+information, fix the gauge, then
    hand off to an optimizer.
    """

    def __init__(self):
        self.vertices: dict[int, VertexRecord] = {}
        self.edges: list[EdgeRecord] = []
        self.parameters: dict[int, tuple] = {}  # id -> (ParameterType, np.ndarray)

    # -- construction -----------------------------------------------------

    def add_vertex(self, vid: int, type_name: str, params,
                   fixed: bool = False, marginalized: bool = False):
        if vid in self.vertices:
            raise ValueError(f"vertex id {vid} already in graph")
        vt = registry.vertex_type(type_name)
        params = np.array(params, dtype=np.float64).reshape(vt.ambient_dim)
        self.vertices[vid] = VertexRecord(vid, vt, params, fixed, marginalized)
        return self.vertices[vid]

    def add_edge(self, type_name: str, vertex_ids: Sequence[int], measurement,
                 information, kernel: str = "None", kernel_delta: float = 1.0,
                 param_ids: Sequence[int] = (), level: int = 0):
        et = registry.edge_type(type_name)
        vertex_ids = tuple(int(v) for v in vertex_ids)
        if len(vertex_ids) != et.num_vertices:
            raise ValueError(
                f"edge {type_name} expects {et.num_vertices} vertices, got {len(vertex_ids)}")
        for s, vid in enumerate(vertex_ids):
            if vid not in self.vertices:
                raise ValueError(f"edge {type_name} references unknown vertex {vid}")
            want = et.vertex_types[s]
            got = self.vertices[vid].vtype.name
            if got != want:
                raise ValueError(
                    f"edge {type_name} slot {s} expects vertex type {want!r}, got {got!r}")
        # copy: callers often pass one shared info array for many edges
        measurement = np.array(measurement, dtype=np.float64).reshape(
            et.measurement_dim)
        information = np.array(information, dtype=np.float64).reshape(
            et.error_dim, et.error_dim)
        rec = EdgeRecord(et, vertex_ids, measurement, information,
                         kernel, float(kernel_delta), tuple(param_ids), level)
        self.edges.append(rec)
        return rec

    def add_parameter(self, pid: int, type_name: str, value):
        pt = registry.parameter_type(type_name)
        self.parameters[int(pid)] = (pt, np.asarray(value, dtype=np.float64).reshape(pt.dim))

    # -- mutation helpers -------------------------------------------------

    def set_fixed(self, vid: int, fixed: bool = True):
        self.vertices[vid].fixed = fixed

    def set_robust_kernel(self, kernel: str, delta: float,
                          edge_type: Optional[str] = None):
        """Assign a robust kernel to all edges (optionally of one type);
        mirrors the CLI's -robustKernel/-robustKernelWidth sweep
        (apps/g2o_cli/g2o.cpp:322-336)."""
        robust.kernel_id(kernel)  # validate
        for e in self.edges:
            if edge_type is None or e.etype.name == edge_type:
                e.kernel = kernel
                e.kernel_delta = float(delta)

    def set_estimate(self, vid: int, params):
        rec = self.vertices[vid]
        rec.params = np.asarray(params, dtype=np.float64).reshape(rec.vtype.ambient_dim)

    # -- queries ----------------------------------------------------------

    def num_vertices(self):
        return len(self.vertices)

    def num_edges(self):
        return len(self.edges)

    def vertices_of_type(self, type_name: str):
        return [v for v in self.vertices.values() if v.vtype.name == type_name]

    def any_fixed(self):
        return any(v.fixed for v in self.vertices.values())

    def gauge_freedom(self):
        """True if the graph needs a gauge (no fixed vertex and no unary
        prior edge grounding it). Simplified from SparseOptimizer::gaugeFreedom
        (sparse_optimizer.cpp:137-163)."""
        if self.any_fixed():
            return False
        return not any(e.etype.num_vertices == 1 for e in self.edges)

    def find_gauge(self):
        """Pick the max-connectivity max-dimension vertex as gauge candidate
        (SparseOptimizer::findGauge, sparse_optimizer.cpp:116-135)."""
        degree = {vid: 0 for vid in self.vertices}
        for e in self.edges:
            for vid in e.vertex_ids:
                degree[vid] += 1
        max_dim = max(v.vtype.tangent_dim for v in self.vertices.values())
        best, best_deg = None, -1
        for vid, v in self.vertices.items():
            if v.vtype.tangent_dim == max_dim and degree[vid] > best_deg:
                best, best_deg = vid, degree[vid]
        return best

    def verify_information_matrices(self, verbose: bool = False):
        """Check every edge's information matrix is symmetric positive
        semi-definite (OptimizableGraph::verifyInformationMatrices,
        optimizable_graph.h:652). Returns (ok, list of offending edge
        indices)."""
        bad = []
        for i, e in enumerate(self.edges):
            info = e.information
            if not np.allclose(info, info.T, atol=1e-9):
                bad.append(i)
                if verbose:
                    print(f"edge {i} ({e.etype.name}): information not "
                          f"symmetric")
                continue
            w = np.linalg.eigvalsh(0.5 * (info + info.T))
            if w.min() < -1e-9:
                bad.append(i)
                if verbose:
                    print(f"edge {i} ({e.etype.name}): information not PSD "
                          f"(min eig {w.min():.3e})")
        return len(bad) == 0, bad

    def subset(self, vertex_ids) -> "Graph":
        """Subgraph induced by `vertex_ids`: those vertices plus every edge
        whose endpoints are all included (saveSubset semantics,
        optimizable_graph.h:604-607)."""
        keep = set(int(v) for v in vertex_ids)
        out = Graph()
        out.parameters = dict(self.parameters)
        for vid in self.vertices:
            if vid in keep:
                rec = self.vertices[vid]
                v = out.add_vertex(vid, rec.vtype.name, rec.params.copy(),
                                   fixed=rec.fixed,
                                   marginalized=rec.marginalized)
                v.data = list(rec.data)
        for e in self.edges:
            if all(v in keep for v in e.vertex_ids):
                out.add_edge(e.etype.name, e.vertex_ids,
                             e.measurement.copy(), e.information.copy(),
                             kernel=e.kernel, kernel_delta=e.kernel_delta,
                             param_ids=e.param_ids, level=e.level)
        return out

    def add_graph(self, other: "Graph"):
        """Merge another graph's vertices/edges (OptimizableGraph::addGraph);
        ids must not collide except for shared parameters."""
        for pid, (pt, vals) in other.parameters.items():
            if pid not in self.parameters:
                self.parameters[pid] = (pt, vals)
        for vid, rec in other.vertices.items():
            v = self.add_vertex(vid, rec.vtype.name, rec.params.copy(),
                                fixed=rec.fixed, marginalized=rec.marginalized)
            v.data = list(rec.data)
        for e in other.edges:
            self.add_edge(e.etype.name, e.vertex_ids, e.measurement.copy(),
                          e.information.copy(), kernel=e.kernel,
                          kernel_delta=e.kernel_delta, param_ids=e.param_ids,
                          level=e.level)
        return self

    # -- lowering ---------------------------------------------------------

    def compile(self, dtype=None, level: int = 0):
        """Lower to a device-side struct-of-arrays Problem.

        The analogue of SparseOptimizer::initializeOptimization +
        buildIndexMapping (sparse_optimizer.cpp:199-263,166-190): vertices are
        grouped by type into padded-free tables, edges grouped by
        (type, robust kernel) into index/measurement/information tables, and
        fixed vertices become multiplicative masks instead of index -1.
        """
        from openslam_g2o_tpu.core.problem import build_problem
        return build_problem(self, dtype=dtype, level=level)
