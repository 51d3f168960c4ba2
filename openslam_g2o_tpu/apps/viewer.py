"""Graph visualization: the g2o_viewer equivalent, headless.

The reference ships a Qt4/QGLViewer GUI (apps/g2o_viewer, run_g2o_viewer.cpp
:66-88) that draws vertices/edges via per-type "draw" HyperGraphElementActions
and writes gnuplot dumps via output_helper.cpp. An accelerator host
usually has no display server, so the equivalent here is headless rendering:

* `plot_graph` -> matplotlib PNG/SVG (2D top-down or 3D projection), with
  optional covariance ellipses from the marginals module,
* `write_gnuplot` -> the reference's gnuplot edge-dump format
  (saveGnuplot, apps/g2o_cli/output_helper.cpp) so existing gnuplot
  tooling keeps working,
* the CLI flags -gnudump and -plot hook these up.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from openslam_g2o_tpu.core.graph import Graph

__all__ = ["plot_graph", "write_gnuplot"]

_POSE2D = ("se2",)
_POSE3D = ("se3", "se3_expmap", "cam", "sim3")
_POINT2D = ("point_xy",)
_POINT3D = ("point_xyz", "sba_point_xyz")


def _positions(graph: Graph):
    """Collect drawable positions via the per-type "draw" action registry
    (core/actions.py — the HyperGraphElementAction dispatch); types without
    a registered draw action are skipped, exactly like the reference
    viewer."""
    from openslam_g2o_tpu.core import actions as A

    pos2, pos3, lm2, lm3 = {}, {}, {}, {}
    buckets = {"pose2": pos2, "pose3": pos3, "point2": lm2, "point3": lm3}
    for prim in A.apply_action(graph, A.DRAW, edges=False):
        if prim is None:
            continue
        kind, vid, xy = prim
        buckets[kind][vid] = xy
    return pos2, pos3, lm2, lm3


def plot_graph(graph: Graph, path: str, title: str = "",
               draw_edges: bool = True, covariances: Optional[dict] = None,
               dpi: int = 120):
    """Render the graph to an image file (PNG/SVG/PDF by extension)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos2, pos3, lm2, lm3 = _positions(graph)
    is3d = bool(pos3 or lm3)

    fig = plt.figure(figsize=(8, 8))
    if is3d:
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = fig.add_subplot(111)
        ax.set_aspect("equal")

    def xy(vid):
        if vid in pos2:
            return pos2[vid]
        if vid in pos3:
            return pos3[vid]
        if vid in lm2:
            return lm2[vid]
        if vid in lm3:
            return lm3[vid]
        return None

    if draw_edges:
        segs_pose, segs_lm = [], []
        for e in graph.edges:
            if len(e.vertex_ids) < 2:
                continue
            a, b = xy(e.vertex_ids[0]), xy(e.vertex_ids[1])
            if a is None or b is None:
                continue
            lm_edge = any(v in lm2 or v in lm3 for v in e.vertex_ids[:2])
            (segs_lm if lm_edge else segs_pose).append((a, b))
        for segs, color, lw, alpha in ((segs_pose, "#3465a4", 0.6, 0.8),
                                       (segs_lm, "#babdb6", 0.3, 0.4)):
            for a, b in segs:
                if is3d:
                    a = np.concatenate([a, [0]]) if len(a) == 2 else a
                    b = np.concatenate([b, [0]]) if len(b) == 2 else b
                    ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]],
                            color=color, lw=lw, alpha=alpha)
                else:
                    ax.plot([a[0], b[0]], [a[1], b[1]], color=color, lw=lw,
                            alpha=alpha)

    if pos2:
        pts = np.stack(list(pos2.values()))
        ax.scatter(pts[:, 0], pts[:, 1], s=4, c="#204a87", zorder=3)
    if lm2:
        pts = np.stack(list(lm2.values()))
        ax.scatter(pts[:, 0], pts[:, 1], s=6, c="#a40000", marker="x", zorder=3)
    if pos3:
        pts = np.stack(list(pos3.values()))
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=4, c="#204a87")
    if lm3:
        pts = np.stack(list(lm3.values()))
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=6, c="#a40000", marker="x")

    # covariance ellipses (2D): {vid: 2x2 or 3x3 block}
    if covariances and not is3d:
        from matplotlib.patches import Ellipse
        for vid, cov in covariances.items():
            p = xy(vid)
            if p is None:
                continue
            c = np.asarray(cov)[:2, :2]
            w, v = np.linalg.eigh(c)
            w = np.maximum(w, 0)
            angle = np.degrees(np.arctan2(v[1, 0], v[0, 0]))
            ax.add_patch(Ellipse(p, 2 * 3 * np.sqrt(w[0]), 2 * 3 * np.sqrt(w[1]),
                                 angle=angle, fill=False, color="#4e9a06",
                                 lw=0.8, alpha=0.7))

    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def write_gnuplot(graph: Graph, path: str):
    """Dump edges in the gnuplot format of the reference's saveGnuplot
    (output_helper.cpp): per edge, endpoint coordinates on consecutive lines
    separated by blank lines. Dispatches through the per-type
    "writeGnuplot" action registry (core/actions.py); edges without a
    registered writer fall back to a generic endpoint dump when both
    endpoints have draw actions."""
    from openslam_g2o_tpu.core import actions as A

    with open(path, "w") as f:
        for e in graph.edges:
            fn = A.action_for(A.WRITE_GNUPLOT, e.etype.name)
            rec = fn(graph, e, None) if fn is not None \
                else A._gnuplot_edge(graph, e, None)
            if rec:
                f.write(rec)
    return path
