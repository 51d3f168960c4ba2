"""Per-element typed action registry: the HyperGraphElementAction system.

The reference dispatches named actions ("draw", "writeGnuplot") to per-type
handlers through a singleton HyperGraphActionLibrary
(g2o/core/hyper_graph_action.h:137-205; applyAction :162; DrawAction :179,
WriteGnuplotAction :167), registered via G2O_REGISTER_ACTION. This build
keeps the same shape host-side: actions are plain functions keyed by
(action name, element type name); `apply_action` walks a Graph and invokes
the matching handler per element. The viewer (apps/viewer.py) and the CLI's
-gnudump route through this registry, so user-registered types extend the
visualization path exactly like in the reference.

Pre/post-iteration graph-level hooks (HyperGraphAction :49-135) live on
`core.algorithms.optimize(pre_iteration=..., post_iteration=...)`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["register_action", "action_for", "registered_actions",
           "apply_action", "DRAW", "WRITE_GNUPLOT"]

DRAW = "draw"
WRITE_GNUPLOT = "writeGnuplot"

# action name -> element type name -> fn(graph, element, params) -> object
_LIBRARY: Dict[str, Dict[str, Callable]] = {}


def register_action(action: str, type_name: str, fn: Callable,
                    overwrite: bool = True):
    """Register `fn` as the handler of `action` for elements whose
    vtype/etype name is `type_name` (G2O_REGISTER_ACTION analogue)."""
    bucket = _LIBRARY.setdefault(action, {})
    if not overwrite and type_name in bucket:
        return bucket[type_name]
    bucket[type_name] = fn
    return fn


def action_for(action: str, type_name: str) -> Optional[Callable]:
    return _LIBRARY.get(action, {}).get(type_name)


def registered_actions():
    """{action name: sorted type names} — the -listActions view."""
    return {a: sorted(types) for a, types in sorted(_LIBRARY.items())}


def apply_action(graph, action: str, params: Optional[dict] = None,
                 vertices: bool = True, edges: bool = True) -> list:
    """Walk the graph, invoking the per-type handler of `action` on every
    element that has one (HyperGraphElementAction::operator() dispatch,
    hyper_graph_action.h:162). Returns the list of handler results in
    element order (vertices by id, then edges)."""
    bucket = _LIBRARY.get(action, {})
    out = []
    if vertices:
        for vid in sorted(graph.vertices):
            rec = graph.vertices[vid]
            fn = bucket.get(rec.vtype.name)
            if fn is not None:
                out.append(fn(graph, rec, params))
    if edges:
        for e in graph.edges:
            fn = bucket.get(e.etype.name)
            if fn is not None:
                out.append(fn(graph, e, params))
    return out


# ---------------------------------------------------------------------------
# Standard registrations: draw + writeGnuplot for the bundled types
# (the per-type action proxies types_*.cpp registers in the reference)
# ---------------------------------------------------------------------------

def _draw_pose2(graph, rec, params):
    return ("pose2", rec.vid, rec.params[:2])


def _draw_pose3(graph, rec, params):
    return ("pose3", rec.vid, rec.params[:3])


def _draw_point2(graph, rec, params):
    return ("point2", rec.vid, rec.params[:2])


def _draw_point3(graph, rec, params):
    return ("point3", rec.vid, rec.params[:3])


_DRAW_KINDS = {"pose2": _draw_pose2, "pose3": _draw_pose3,
               "point2": _draw_point2, "point3": _draw_point3}

_POSE2D = ("se2",)
_POSE3D = ("se3", "se3_expmap", "cam", "sim3", "scam")
_POINT2D = ("point_xy",)
_POINT3D = ("point_xyz", "sba_point_xyz")

for _n in _POSE2D:
    register_action(DRAW, _n, _draw_pose2)
for _n in _POSE3D:
    register_action(DRAW, _n, _draw_pose3)
for _n in _POINT2D:
    register_action(DRAW, _n, _draw_point2)
for _n in _POINT3D:
    register_action(DRAW, _n, _draw_point3)


def _gnuplot_edge(graph, e, params):
    """Endpoint coordinates on consecutive lines, blank-line separated —
    the saveGnuplot record format (apps/g2o_cli/output_helper.cpp)."""
    if len(e.vertex_ids) < 2:
        return None
    coords = []
    for vid in e.vertex_ids[:2]:
        rec = graph.vertices[vid]
        prim = apply_draw_to_vertex(graph, rec)
        if prim is not None:
            coords.append(prim[2])
    if len(coords) != 2:
        return None
    return "".join(" ".join(repr(float(v)) for v in c) + "\n"
                   for c in coords) + "\n"


def apply_draw_to_vertex(graph, rec):
    fn = action_for(DRAW, rec.vtype.name)
    return None if fn is None else fn(graph, rec, None)


_GNUPLOT_EDGES = ("edge_se2", "edge_se2_xy", "edge_bearing_se2_xy",
                  "edge_se2_offset", "edge_se2_pointxy_offset",
                  "edge_se2_xy_calib", "edge_se3", "edge_se3_trackxyz",
                  "edge_se3_offset", "edge_sim3", "edge_se3_expmap",
                  "edge_gicp", "edge_se2_calib")

for _n in _GNUPLOT_EDGES:
    register_action(WRITE_GNUPLOT, _n, _gnuplot_edge)
