"""Interactive SLAM protocol server: ADD / FIX / SOLVE_STATE / QUERY_STATE.

Re-implements the interactive_slam text protocol
(g2o_interactive/protocol.txt) and the G2OSlamInterface command mapping
(g2o_slam_interface.h:49-57, .cpp) on top of the online optimizer. The
reference parses with a flex/bison grammar (slam_parser/parser/parser.yy);
the grammar is regular enough that a tokenizer + dispatch table is the whole
parser here.

Commands (semicolon- or newline-terminated):
  ADD VERTEX_XYT id [x y theta];
  ADD VERTEX_XYZRPY id [x y z roll pitch yaw];
  ADD EDGE_XYT eid id1 id2 x y t  i11 i12 i13 i22 i23 i33;
  ADD EDGE_XYZRPY eid id1 id2 x y z r p yw  <21 upper-tri info entries>;
  FIX id...;
  SOLVE_STATE;
  QUERY_STATE [id...];   ->  BEGIN / VERTEX_* lines / END

2D poses are SE2 vertices; 3D poses are SE3 (quaternion) vertices with
Euler roll-pitch-yaw conversion at the protocol boundary
(isometry3d_mappings.cpp:48-77 toEuler/fromEuler).
"""
from __future__ import annotations

import math
import sys
from typing import Optional

import numpy as np

from openslam_g2o_tpu.core.online import OnlineOptimizer
from openslam_g2o_tpu.utils import np_lie

__all__ = ["SlamInterface", "run_protocol", "main"]


def rpy_to_quat(r, p, y):
    """fromEuler (isometry3d_mappings.cpp:61-77), returns (qx,qy,qz,qw)."""
    sy, cy = math.sin(y * 0.5), math.cos(y * 0.5)
    sp, cp = math.sin(p * 0.5), math.cos(p * 0.5)
    sr, cr = math.sin(r * 0.5), math.cos(r * 0.5)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def quat_to_rpy(q):
    """toEuler (isometry3d_mappings.cpp:48-59)."""
    qx, qy, qz, qw = q
    roll = math.atan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    pitch = math.asin(max(-1.0, min(1.0, 2 * (qw * qy - qz * qx))))
    yaw = math.atan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    return roll, pitch, yaw


def _upper_tri_to_full(vals, d):
    m = np.zeros((d, d))
    iu = np.triu_indices(d)
    m[iu] = vals
    return m + m.T - np.diag(np.diag(m))


class SlamInterface:
    """Protocol command handlers over an OnlineOptimizer
    (the G2OSlamInterface equivalent)."""

    def __init__(self, optimizer: Optional[OnlineOptimizer] = None,
                 out=None):
        self.oo = optimizer or OnlineOptimizer()
        self.out = out or sys.stdout
        self._kinds = {}         # vid -> "xyt" | "xyzrpy"
        self._first_fixed = False

    # -- commands ----------------------------------------------------------

    def add_vertex_xyt(self, vid, init):
        params = np.asarray(init if init is not None else [0.0, 0.0, 0.0])
        self.oo.add_vertex(vid, "se2", params)
        self._kinds[vid] = "xyt"

    def add_vertex_xyzrpy(self, vid, init):
        if init is None:
            params = np.array([0, 0, 0, 0, 0, 0, 1.0])
        else:
            x, y, z, r, p, yw = init
            params = np.concatenate([[x, y, z], rpy_to_quat(r, p, yw)])
        self.oo.add_vertex(vid, "se3", params)
        self._kinds[vid] = "xyzrpy"

    def add_edge_xyt(self, eid, id1, id2, meas, info_upper):
        for vid in (id1, id2):
            if vid not in self.oo.graph.vertices:
                self.add_vertex_xyt(vid, None)
        self.oo.add_edge("edge_se2", (id1, id2), np.asarray(meas),
                         _upper_tri_to_full(info_upper, 3))
        self._auto_fix(id1)

    def add_edge_xyzrpy(self, eid, id1, id2, meas, info_upper):
        for vid in (id1, id2):
            if vid not in self.oo.graph.vertices:
                self.add_vertex_xyzrpy(vid, None)
        x, y, z, r, p, yw = meas
        m = np.concatenate([[x, y, z], rpy_to_quat(r, p, yw)])
        self.oo.add_edge("edge_se3", (id1, id2), m,
                         _upper_tri_to_full(info_upper, 6))
        self._auto_fix(id1)

    def _auto_fix(self, vid):
        # the protocol allows omitting FIX; anchor the first referenced
        # vertex (g2o_slam_interface.cpp does the same for vertex 0)
        if not self._first_fixed:
            self.oo.fix(vid)
            self._first_fixed = True

    def fix(self, vids):
        for vid in vids:
            if vid in self.oo.graph.vertices:
                self.oo.fix(vid)
                self._first_fixed = True

    def solve_state(self):
        # the protocol's SOLVE_STATE response carries estimates, not
        # per-iteration stats — skip the trajectory fetch (one device
        # sync per solve)
        self.oo.solve(want_stats=False)

    def query_state(self, vids):
        print("BEGIN", file=self.out)
        if not vids:
            vids = sorted(self.oo.graph.vertices)
        for vid in vids:
            if vid not in self.oo.graph.vertices:
                continue
            p = self.oo.estimate(vid)
            if self._kinds.get(vid) == "xyzrpy":
                r, pt, yw = quat_to_rpy(p[3:7])
                vals = [p[0], p[1], p[2], r, pt, yw]
                print(f"VERTEX_XYZRPY {vid} " + " ".join(
                    f"{v:.10g}" for v in vals), file=self.out)
            else:
                print(f"VERTEX_XYT {vid} " + " ".join(
                    f"{v:.10g}" for v in p[:3]), file=self.out)
        print("END", file=self.out)
        self.out.flush()

    # -- parsing -----------------------------------------------------------

    def handle_line(self, line: str):
        for stmt in line.split(";"):
            toks = stmt.split()
            if not toks:
                continue
            cmd = toks[0].upper()
            try:
                if cmd == "ADD":
                    self._handle_add(toks[1:])
                elif cmd == "FIX":
                    self.fix([int(t) for t in toks[1:]])
                elif cmd == "SOLVE_STATE":
                    self.solve_state()
                elif cmd == "QUERY_STATE":
                    self.query_state([int(t) for t in toks[1:]])
                else:
                    print(f"# unknown command {cmd}", file=sys.stderr)
            except (ValueError, IndexError) as e:
                print(f"# parse error in {stmt!r}: {e}", file=sys.stderr)

    def _handle_add(self, toks):
        kind = toks[0].upper()
        if kind == "VERTEX_XYT":
            vid = int(toks[1])
            init = [float(t) for t in toks[2:5]] if len(toks) >= 5 else None
            self.add_vertex_xyt(vid, init)
        elif kind == "VERTEX_XYZRPY":
            vid = int(toks[1])
            init = [float(t) for t in toks[2:8]] if len(toks) >= 8 else None
            self.add_vertex_xyzrpy(vid, init)
        elif kind == "EDGE_XYT":
            eid, id1, id2 = int(toks[1]), int(toks[2]), int(toks[3])
            vals = [float(t) for t in toks[4:]]
            self.add_edge_xyt(eid, id1, id2, vals[:3], vals[3:9])
        elif kind == "EDGE_XYZRPY":
            eid, id1, id2 = int(toks[1]), int(toks[2]), int(toks[3])
            vals = [float(t) for t in toks[4:]]
            self.add_edge_xyzrpy(eid, id1, id2, vals[:6], vals[6:27])
        else:
            print(f"# unknown ADD kind {kind}", file=sys.stderr)


def run_protocol(lines, interface: Optional[SlamInterface] = None):
    iface = interface or SlamInterface()
    for line in lines:
        iface.handle_line(line)
    return iface


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="g2o_interactive",
        description="interactive SLAM protocol server (reads stdin)")
    p.add_argument("-updateEachN", type=int, default=1,
                   help="solve every N SOLVE_STATE commands")
    p.add_argument("-iterations", type=int, default=3,
                   help="iterations per solve")
    args = p.parse_args(argv)
    # the protocol server runs on the ELL-PCG fast path (padding-masked
    # patterns, one fused device program per solve — core/online.py)
    from openslam_g2o_tpu.core.algorithms import LevenbergMarquardtPCG
    iface = SlamInterface(OnlineOptimizer(
        algorithm=LevenbergMarquardtPCG(pcg_iters=200, pcg_tol=1e-2),
        iterations_per_solve=args.iterations))
    for line in sys.stdin:
        iface.handle_line(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
