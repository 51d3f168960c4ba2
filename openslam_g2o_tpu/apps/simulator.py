"""Synthetic dataset generator: the g2o_simulator equivalent.

Re-designs apps/g2o_simulator (simulator.h:42-280: World + Robot + pluggable
Unary/Binary sensors; binaries test_simulator2d/3d.cpp) as host-side numpy
generators that emit Graph objects (and .g2o files). Ground truth is kept so
tests can assert ATE, exactly like the reference uses simulator output as its
test fixture (SURVEY §4.3).

Sensors implemented (mirroring sensor_*.cpp):
- 2D: odometry (EDGE_SE2), pose loop closures (EDGE_SE2), landmark
  range (EDGE_SE2_XY), landmark bearing (EDGE_BEARING_SE2_XY).
- 3D: odometry (EDGE_SE3:QUAT), pose loop closures, landmark depth
  (EDGE_SE3_TRACKXYZ with identity offset parameter).
- create_sphere: the examples/sphere/create_sphere.cpp benchmark generator.

Noise model: Gaussian on the measurement in its own space (Sampler,
g2o/stuff/sampler.h:49-95); information = inverse covariance.
"""
from __future__ import annotations

import math

import numpy as np

from openslam_g2o_tpu.core.graph import Graph
from openslam_g2o_tpu.utils import np_lie

__all__ = ["Simulator2D", "Simulator3D", "create_sphere"]


def _info_from_sigmas(sigmas):
    return np.diag(1.0 / np.asarray(sigmas) ** 2)


def _revisits(pos, radius, min_gap=5):
    """Pairs (i, j), j >= i + min_gap, in row-major order, whose positions
    lie within `radius`: the pose sensor's loop-closure candidates. A
    vectorized pre-filter per i, with the exact per-pair distance test
    re-applied so that the pairs (and the random draws that follow them)
    are those of the plain double loop."""
    n = len(pos)
    for i in range(n - min_gap):
        d = np.linalg.norm(pos[i + min_gap:] - pos[i], axis=1)
        for j in i + min_gap + np.nonzero(d < radius * (1 + 1e-9))[0]:
            if np.linalg.norm(pos[i] - pos[j]) < radius:
                yield i, int(j)


class Simulator2D:
    """2D robot in a planar world with landmarks (test_simulator2d.cpp)."""

    def __init__(self, world_size: float = 25.0, n_landmarks: int = 100,
                 trans_noise=(0.05, 0.01), rot_noise=0.02,
                 landmark_noise=(0.05, 0.05), sensor_range: float = 3.0,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.world_size = world_size
        self.landmarks = self.rng.uniform(0, world_size, size=(n_landmarks, 2))
        self.trans_noise = trans_noise
        self.rot_noise = rot_noise
        self.landmark_noise = landmark_noise
        self.sensor_range = sensor_range

    def _motion(self, step: int):
        """Manhattan-style grid walk: mostly straight, occasional +-90 turns
        (the motion model behind manhattanOlson-style datasets)."""
        if self.rng.random() < 0.25:
            turn = self.rng.choice([-1.0, 1.0]) * math.pi / 2
        else:
            turn = 0.0
        return np.array([1.0, 0.0, turn])

    def simulate(self, n_poses: int = 300, landmark_obs: bool = True,
                 bearing_only: bool = False, loop_closures: bool = True):
        g = Graph()
        odo_info = _info_from_sigmas(
            [*self.trans_noise, self.rot_noise])
        lm_info = _info_from_sigmas(self.landmark_noise)
        bearing_info = _info_from_sigmas([self.rot_noise])

        gt = np.zeros((n_poses, 3))
        pose = np.array([self.world_size / 2, self.world_size / 2, 0.0])
        for i in range(n_poses):
            gt[i] = pose
            if i + 1 < n_poses:
                motion = self._motion(i)
                nxt = np_lie.se2_compose(pose, motion)
                # keep the robot in the world: turn around at the border
                if not (0 <= nxt[0] <= self.world_size
                        and 0 <= nxt[1] <= self.world_size):
                    motion = np.array([0.0, 0.0, math.pi / 2])
                    nxt = np_lie.se2_compose(pose, motion)
                pose = nxt

        noisy = gt.copy()
        g.add_vertex(0, "se2", gt[0], fixed=True)
        for i in range(1, n_poses):
            z = np_lie.se2_compose(np_lie.se2_inverse(gt[i - 1]), gt[i])
            zn = z + self.rng.normal(
                0, [*self.trans_noise, self.rot_noise])
            zn[2] = np_lie.normalize_angle(zn[2])
            noisy[i] = np_lie.se2_compose(noisy[i - 1], zn)
            noisy[i][2] = np_lie.normalize_angle(noisy[i][2])
            g.add_vertex(i, "se2", noisy[i])
            g.add_edge("edge_se2", (i - 1, i), zn, odo_info)

        if loop_closures:
            # pose sensor: relative constraints to revisited poses
            for i, j in _revisits(gt[:, :2], 1.0):
                if self.rng.random() < 0.3:
                    z = np_lie.se2_compose(np_lie.se2_inverse(gt[i]), gt[j])
                    zn = z + self.rng.normal(
                        0, [*self.trans_noise, self.rot_noise])
                    zn[2] = np_lie.normalize_angle(zn[2])
                    g.add_edge("edge_se2", (i, j), zn, odo_info)

        lm_seen = {}
        if landmark_obs:
            for i in range(n_poses):
                d = np.linalg.norm(self.landmarks - gt[i][:2], axis=1)
                for li in np.nonzero(d < self.sensor_range)[0]:
                    vid = 10000 + int(li)
                    obs = np_lie.se2_apply(np_lie.se2_inverse(gt[i]),
                                           self.landmarks[li])
                    if vid not in lm_seen:
                        lm_seen[vid] = True
                        init = np_lie.se2_apply(noisy[i], obs)
                        g.add_vertex(vid, "point_xy", init)
                    if bearing_only:
                        z = np.array([math.atan2(obs[1], obs[0])
                                      + self.rng.normal(0, self.rot_noise)])
                        g.add_edge("edge_se2_xy_bearing", (i, vid), z,
                                   bearing_info)
                    else:
                        zn = obs + self.rng.normal(0, self.landmark_noise)
                        g.add_edge("edge_se2_xy", (i, vid), zn, lm_info)

        return g, gt


class Simulator3D:
    """3D robot on a random walk with XYZ landmarks (test_simulator3d.cpp)."""

    def __init__(self, world_size: float = 20.0, n_landmarks: int = 200,
                 trans_noise=(0.05, 0.05, 0.05), rot_noise=0.01,
                 landmark_noise=(0.05, 0.05, 0.05), sensor_range: float = 4.0,
                 seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.world_size = world_size
        self.landmarks = self.rng.uniform(0, world_size, size=(n_landmarks, 3))
        self.trans_noise = np.asarray(trans_noise)
        self.rot_noise = rot_noise
        self.landmark_noise = np.asarray(landmark_noise)
        self.sensor_range = sensor_range

    def _rand_quat(self, scale):
        v = self.rng.normal(0, scale, 3)
        w = math.sqrt(max(0.0, 1 - np.dot(v, v)))
        q = np.array([*v, w])
        return q / np.linalg.norm(q)

    def simulate(self, n_poses: int = 200, landmark_obs: bool = True,
                 loop_closures: bool = True):
        g = Graph()
        g.add_parameter(0, "se3_offset", [0, 0, 0, 0, 0, 0, 1])
        odo_info = _info_from_sigmas([*self.trans_noise] + [self.rot_noise] * 3)
        lm_info = _info_from_sigmas(self.landmark_noise)

        gt = np.zeros((n_poses, 7))
        pose = np.array([self.world_size / 2, self.world_size / 2,
                         self.world_size / 2, 0, 0, 0, 1.0])
        for i in range(n_poses):
            gt[i] = pose
            if i + 1 < n_poses:
                motion = np.concatenate([[1.0, 0, 0], self._rand_quat(0.15)])
                nxt = np_lie.se3_compose(pose, motion)
                if not np.all((0 <= nxt[:3]) & (nxt[:3] <= self.world_size)):
                    # bounce: turn ~90 degrees about z
                    motion = np.concatenate(
                        [[0, 0, 0], [0, 0, math.sin(0.8), math.cos(0.8)]])
                    nxt = np_lie.se3_compose(pose, motion)
                pose = nxt

        noisy = gt.copy()
        g.add_vertex(0, "se3", gt[0], fixed=True)
        for i in range(1, n_poses):
            z = np_lie.se3_compose(np_lie.se3_inverse(gt[i - 1]), gt[i])
            dq = self._rand_quat(self.rot_noise)
            zn = np_lie.se3_compose(
                np.concatenate([self.rng.normal(0, self.trans_noise),
                                dq]), z)
            noisy[i] = np_lie.se3_compose(noisy[i - 1], zn)
            g.add_vertex(i, "se3", noisy[i])
            g.add_edge("edge_se3", (i - 1, i), zn, odo_info)

        if loop_closures:
            for i, j in _revisits(gt[:, :3], 1.5):
                if self.rng.random() < 0.3:
                    z = np_lie.se3_compose(np_lie.se3_inverse(gt[i]), gt[j])
                    g.add_edge("edge_se3", (i, j), z, odo_info)

        if landmark_obs:
            seen = set()
            for i in range(n_poses):
                d = np.linalg.norm(self.landmarks - gt[i][:3], axis=1)
                for li in np.nonzero(d < self.sensor_range)[0]:
                    vid = 10000 + int(li)
                    obs = np_lie.se3_apply(np_lie.se3_inverse(gt[i]),
                                           self.landmarks[li])
                    if vid not in seen:
                        seen.add(vid)
                        g.add_vertex(vid, "point_xyz",
                                     np_lie.se3_apply(noisy[i], obs))
                    zn = obs + self.rng.normal(0, self.landmark_noise)
                    g.add_edge("edge_se3_xyz", (i, vid), zn, lm_info,
                               param_ids=[0])
        return g, gt


def create_sphere(n_laps: int = 50, n_per_lap: int = 50, radius: float = 100.0,
                  trans_noise=(0.1, 0.1, 0.1), rot_noise: float = 0.02,
                  seed: int = 0):
    """The sphere benchmark generator (examples/sphere/create_sphere.cpp):
    a pose spiral over a sphere with odometry + inter-lap closures."""
    rng = np.random.default_rng(seed)
    g = Graph()
    info = _info_from_sigmas([*trans_noise] + [rot_noise] * 3)

    gt = []
    for i in range(n_laps * n_per_lap):
        phi = 2 * math.pi * (i % n_per_lap) / n_per_lap
        theta = math.pi * (i / (n_laps * n_per_lap))
        p = radius * np.array([math.sin(theta) * math.cos(phi),
                               math.sin(theta) * math.sin(phi),
                               math.cos(theta)])
        # orientation: z along -radial, x along direction of travel
        zax = -p / max(np.linalg.norm(p), 1e-9)
        xax = np.array([-math.sin(phi), math.cos(phi), 0.0])
        yax = np.cross(zax, xax)
        R = np.stack([xax, yax, zax], axis=1)
        # rotation matrix -> quaternion (Shepperd)
        t = np.trace(R)
        if t > 0:
            s = math.sqrt(t + 1.0) * 2
            q = np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                          (R[1, 0] - R[0, 1]) / s, 0.25 * s])
        else:
            k = int(np.argmax(np.diag(R)))
            i1, i2 = (k + 1) % 3, (k + 2) % 3
            s = math.sqrt(R[k, k] - R[i1, i1] - R[i2, i2] + 1.0) * 2
            q = np.zeros(4)
            q[k] = 0.25 * s
            q[i1] = (R[i1, k] + R[k, i1]) / s
            q[i2] = (R[i2, k] + R[k, i2]) / s
            q[3] = (R[i2, i1] - R[i1, i2]) / s
        q /= np.linalg.norm(q)
        gt.append(np.concatenate([p, q]))
    gt = np.stack(gt)

    def noisy_rel(a, b):
        z = np_lie.se3_compose(np_lie.se3_inverse(a), b)
        v = rng.normal(0, rot_noise, 3)
        w = math.sqrt(max(0.0, 1 - np.dot(v, v)))
        dq = np.array([*v, w])
        return np_lie.se3_compose(
            np.concatenate([rng.normal(0, trans_noise), dq / np.linalg.norm(dq)]), z)

    n = len(gt)
    noisy = gt.copy()
    g.add_vertex(0, "se3", gt[0], fixed=True)
    for i in range(1, n):
        zn = noisy_rel(gt[i - 1], gt[i])
        noisy[i] = np_lie.se3_compose(noisy[i - 1], zn)
        g.add_vertex(i, "se3", noisy[i])
        g.add_edge("edge_se3", (i - 1, i), zn, info)
    # inter-lap closures: connect to the pose one lap earlier
    for i in range(n_per_lap, n):
        j = i - n_per_lap
        if rng.random() < 0.5:
            g.add_edge("edge_se3", (j, i), noisy_rel(gt[j], gt[i]), info)
    return g, gt


def synthetic_pose_graph_2d(n_poses: int = 100000, grid: int = 100,
                            trans_noise: float = 0.05,
                            rot_noise: float = 0.01, closure_prob: float = 0.5,
                            seed: int = 0, dtype=None):
    """Large SE2 pose graph, built directly into device tables (the 100k+
    analogue of the Manhattan/grid datasets — simulator2d.cpp workload
    shape at a scale the bundled files never reach).

    Geometry: serpentine (boustrophedon) sweeps over a grid x grid lattice,
    repeated until n_poses; loop closures connect each pose to the pose one
    sweep earlier in the same cell (the create_sphere inter-lap pattern,
    flattened). Construction is fully vectorized numpy — cumsum integrates
    both the ground-truth trajectory and the noisy odometry init — so a
    100k-pose graph builds in O(100 ms), not minutes of per-record Graph
    bookkeeping.

    Noise is drawn with the exact sigmas the information matrix encodes, so
    the converged chi2 has a computable noise floor:
    E[chi2_min] ~ 3*E - 3*(N-1)  (whitened residual dof) — the convergence
    gate for shapes with no recorded reference minimum (BASELINE.md
    protocol, same role as expected_ba_chi2).

    Returns (Problem, info dict with gt trajectory + n_edges)."""
    import jax.numpy as jnp
    from openslam_g2o_tpu.core import problem as P
    from openslam_g2o_tpu.core import registry, robust

    rng = np.random.default_rng(seed)
    N = n_poses
    sweep = grid * grid

    # serpentine lattice coordinates for pose index i (vectorized)
    i = np.arange(N)
    cell = i % sweep
    row = cell // grid
    col_in = cell % grid
    col = np.where(row % 2 == 0, col_in, grid - 1 - col_in)
    # successive sweeps alternate row direction so the walk is continuous
    srow = np.where((i // sweep) % 2 == 0, row, grid - 1 - row)
    x = col.astype(np.float64)
    y = srow.astype(np.float64)

    # headings: direction of the NEXT step (last pose repeats its prior)
    dx = np.diff(x, append=x[-1])
    dy = np.diff(y, append=y[-1])
    dx[-1], dy[-1] = dx[-2], dy[-2]
    theta = np.arctan2(dy, dx)
    gt = np.stack([x, y, theta], axis=1)

    # odometry edges i -> i+1: z = T_i^-1 * T_{i+1} (+ noise with the
    # information's sigmas)
    ii_o = np.arange(N - 1)
    jj_o = ii_o + 1
    c, s = np.cos(theta[ii_o]), np.sin(theta[ii_o])
    rdx = x[jj_o] - x[ii_o]
    rdy = y[jj_o] - y[ii_o]
    zx = c * rdx + s * rdy
    zy = -s * rdx + c * rdy
    zth = np_lie.normalize_angle(theta[jj_o] - theta[ii_o])
    z_odo = np.stack([zx, zy, zth], axis=1)
    z_odo[:, :2] += rng.normal(0, trans_noise, (N - 1, 2))
    z_odo[:, 2] = np_lie.normalize_angle(
        z_odo[:, 2] + rng.normal(0, rot_noise, N - 1))

    # closures: pose i -> i - sweep (same lattice cell, one sweep earlier)
    cand = np.arange(sweep, N)
    cand = cand[rng.random(len(cand)) < closure_prob]
    ii_c = cand - sweep
    jj_c = cand
    c, s = np.cos(theta[ii_c]), np.sin(theta[ii_c])
    rdx = x[jj_c] - x[ii_c]
    rdy = y[jj_c] - y[ii_c]
    z_clo = np.stack([c * rdx + s * rdy, -s * rdx + c * rdy,
                      np_lie.normalize_angle(theta[jj_c] - theta[ii_c])],
                     axis=1)
    z_clo[:, :2] += rng.normal(0, trans_noise, (len(cand), 2))
    z_clo[:, 2] = np_lie.normalize_angle(
        z_clo[:, 2] + rng.normal(0, rot_noise, len(cand)))

    ii = np.concatenate([ii_o, ii_c]).astype(np.int32)
    jj = np.concatenate([jj_o, jj_c]).astype(np.int32)
    meas = np.concatenate([z_odo, z_clo])
    E = len(meas)
    info = np.diag([1.0 / trans_noise ** 2, 1.0 / trans_noise ** 2,
                    1.0 / rot_noise ** 2])

    # noisy init: integrate the noisy odometry chain (cumsum — the
    # spanning-tree initial guess the file datasets ship with)
    th0 = theta[0] + np.concatenate(
        [[0.0], np.cumsum(z_odo[:, 2])])
    cth, sth = np.cos(th0[:-1]), np.sin(th0[:-1])
    step = np.stack([cth * z_odo[:, 0] - sth * z_odo[:, 1],
                     sth * z_odo[:, 0] + cth * z_odo[:, 1]], axis=1)
    pos0 = np.concatenate([[gt[0, :2]], gt[0, :2] + np.cumsum(step, axis=0)])
    init = np.stack([pos0[:, 0], pos0[:, 1],
                     np_lie.normalize_angle(th0)], axis=1)

    if dtype is None:
        dtype = jnp.zeros((), jnp.float64).dtype
    vt = registry.vertex_type("se2")
    et = registry.edge_type("edge_se2")
    free = np.ones(N)
    free[0] = 0.0
    init[0] = gt[0]
    vg = P.VGroup("se2", vt, N, 0)
    eg = P.EGroup(et.name, et, robust.NONE_ID, E)
    static = P.ProblemStatic((vg,), (eg,), 3 * N, 3 * N)
    edges = {et.name: P.EdgeArrays(
        (jnp.asarray(ii), jnp.asarray(jj)),
        jnp.asarray(meas, dtype=dtype),
        jnp.asarray(np.tile(info, (E, 1, 1)), dtype=dtype),
        jnp.ones((E,), dtype=dtype),
        ())}
    prob = P.Problem(
        params={"se2": jnp.asarray(init, dtype=dtype)},
        free={"se2": jnp.asarray(free, dtype=dtype)},
        edges=edges, static=static)
    return prob, {"gt": gt, "n_edges": E,
                  "noise_floor_chi2": 3.0 * E - 3.0 * (N - 1)}


def synthetic_bal_problem(n_cams: int = 400, n_points: int = 50000,
                          obs_per_point: int = 8, pixel_noise: float = 1.0,
                          cam_noise: float = 0.02, point_noise: float = 0.1,
                          focal: float = 800.0, seed: int = 0, dtype=None):
    """BAL-style large bundle adjustment problem, built directly into device
    arrays (examples/bal/bal_example.cpp workload shape: ring of cameras
    looking inward at a point cloud, each point seen by its nearest cameras).

    Construction bypasses per-record Graph bookkeeping — at venice scale
    (~1e5 points, ~1e6 observations) the struct-of-arrays tables are built
    with vectorized numpy in O(seconds). Returns (Problem, ground_truth dict).
    """
    import jax.numpy as jnp
    from openslam_g2o_tpu.core.graph import Graph
    from openslam_g2o_tpu.core import problem as P
    from openslam_g2o_tpu.core import registry, robust

    rng = np.random.default_rng(seed)
    R = 20.0
    angles = 2 * np.pi * np.arange(n_cams) / n_cams
    centers = np.stack([R * np.cos(angles), R * np.sin(angles),
                        rng.uniform(-2, 2, n_cams)], axis=1)
    pts_gt = rng.uniform(-8, 8, size=(n_points, 3))

    # camera orientation: z-axis looks at the origin
    def look_at_quat(c):
        z = -c / np.linalg.norm(c)
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        x /= np.maximum(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        Rm = np.stack([x, y, z], axis=1)
        t = np.trace(Rm)
        if t > 0:
            s = np.sqrt(t + 1) * 2
            q = np.array([(Rm[2, 1] - Rm[1, 2]) / s, (Rm[0, 2] - Rm[2, 0]) / s,
                          (Rm[1, 0] - Rm[0, 1]) / s, 0.25 * s])
        else:
            k = int(np.argmax(np.diag(Rm)))
            i1, i2 = (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(Rm[k, k] - Rm[i1, i1] - Rm[i2, i2] + 1) * 2
            q = np.zeros(4)
            q[k] = 0.25 * s
            q[i1] = (Rm[i1, k] + Rm[k, i1]) / s
            q[i2] = (Rm[i2, k] + Rm[k, i2]) / s
            q[3] = (Rm[i2, i1] - Rm[i1, i2]) / s
        return q / np.linalg.norm(q)

    c2w = np.zeros((n_cams, 7))
    for i in range(n_cams):
        c2w[i, :3] = centers[i]
        c2w[i, 3:] = look_at_quat(centers[i])
    w2c_gt = np.stack([np_lie.se3_inverse(c2w[i]) for i in range(n_cams)])

    # observations: each point seen by its obs_per_point nearest cameras
    d2 = ((pts_gt[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    nearest = np.argsort(d2, axis=1)[:, :obs_per_point]          # [P, m]
    cam_idx = nearest.reshape(-1).astype(np.int32)
    pt_idx = np.repeat(np.arange(n_points, dtype=np.int32), obs_per_point)

    # project (vectorized)
    t = w2c_gt[cam_idx, :3]
    q = w2c_gt[cam_idx, 3:7]
    u, w = q[:, :3], q[:, 3:4]
    v = pts_gt[pt_idx]
    uv_ = np.cross(u, v)
    pc = v + 2.0 * (w * uv_ + np.cross(u, uv_)) + t
    valid = pc[:, 2] > 1.0
    cam_idx, pt_idx, pc = cam_idx[valid], pt_idx[valid], pc[valid]
    obs = pc[:, :2] / pc[:, 2:3] * focal
    obs += rng.normal(0, pixel_noise, obs.shape)
    E = len(obs)

    # noisy initialization (host-side small-angle perturbation: exp(xi) ~
    # (upsilon, omega/2) quaternion for the noise magnitudes used here)
    cam_init = w2c_gt.copy()
    for i in range(1, n_cams):  # cam 0 fixed = gauge
        om = rng.normal(0, cam_noise, 3)
        ups = rng.normal(0, cam_noise, 3)
        qn = np.concatenate([0.5 * om, [1.0]])
        qn /= np.linalg.norm(qn)
        cam_init[i] = np_lie.se3_compose(np.concatenate([ups, qn]), w2c_gt[i])
    pts_init = pts_gt + rng.normal(0, point_noise, pts_gt.shape)

    if dtype is None:
        dtype = jnp.zeros((), jnp.float64).dtype
    cam_vt = registry.vertex_type("se3_expmap")
    pt_vt = registry.vertex_type("sba_point_xyz")
    et = registry.edge_type("edge_project_xyz2uv")

    free_cam = np.ones(n_cams)
    free_cam[0] = 0.0
    vg_cam = P.VGroup("se3_expmap", cam_vt, n_cams, 0)
    vg_pt = P.VGroup("sba_point_xyz", pt_vt, n_points, n_cams * 6)
    eg = P.EGroup(et.name, et, robust.NONE_ID, E)
    static = P.ProblemStatic((vg_cam, vg_pt), (eg,),
                             n_cams * 6 + n_points * 3, n_cams * 6)
    cam_params = np.tile([focal, 0.0, 0.0, 0.0], (E, 1))
    edges = {et.name: P.EdgeArrays(
        (jnp.asarray(pt_idx), jnp.asarray(cam_idx)),
        jnp.asarray(obs, dtype=dtype),
        jnp.asarray(np.tile(np.eye(2), (E, 1, 1)), dtype=dtype),
        jnp.ones((E,), dtype=dtype),
        (jnp.asarray(cam_params, dtype=dtype),))}
    prob = P.Problem(
        params={"se3_expmap": jnp.asarray(cam_init, dtype=dtype),
                "sba_point_xyz": jnp.asarray(pts_init, dtype=dtype)},
        free={"se3_expmap": jnp.asarray(free_cam, dtype=dtype),
              "sba_point_xyz": jnp.ones((n_points,), dtype=dtype)},
        edges=edges, static=static)
    gt = {"cams_w2c": w2c_gt, "points": pts_gt, "n_obs": E}
    return prob, gt


def main(argv=None):
    import argparse
    from openslam_g2o_tpu.io.g2o_format import save_g2o

    p = argparse.ArgumentParser(
        prog="g2o_simulator",
        description="synthetic dataset generator (g2o_simulator equivalent)")
    p.add_argument("output", help="output .g2o file")
    p.add_argument("-type", choices=["2d", "3d", "sphere"], default="2d")
    p.add_argument("-nodes", type=int, default=300)
    p.add_argument("-nlandmarks", type=int, default=100)
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-bearingOnly", action="store_true")
    p.add_argument("-noLoop", action="store_true")
    args = p.parse_args(argv)

    if args.type == "2d":
        sim = Simulator2D(n_landmarks=args.nlandmarks, seed=args.seed)
        g, _ = sim.simulate(args.nodes, bearing_only=args.bearingOnly,
                            loop_closures=not args.noLoop)
    elif args.type == "3d":
        sim = Simulator3D(n_landmarks=args.nlandmarks, seed=args.seed)
        g, _ = sim.simulate(args.nodes, loop_closures=not args.noLoop)
    else:
        g, _ = create_sphere(seed=args.seed)
    save_g2o(g, args.output)
    print(f"wrote {g.num_vertices()} vertices, {g.num_edges()} edges "
          f"to {args.output}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
