"""Minimal JAX visual front-end: detect + describe + match.

The reference consumes already-built constraint graphs and has no image
front-end (its closest analogue is the measurement simulator,
g2o/apps/g2o_simulator/); an end-to-end "feature detect+match front-end"
is on the roadmap (ROADMAP.md), so this module provides a minimal version
(scope recorded in BASELINE.md):

* Shi-Tomasi corner scoring as pure convolutions (Sobel gradients +
  box-filtered structure tensor + closed-form min-eigenvalue) — dense
  work, batched over frames with vmap.
* Non-max suppression via reduce_window max-pooling, top-k keypoints with
  STATIC shapes (max_kp padded, validity mask) — jit-friendly throughout.
* Patch descriptors (zero-mean, unit-norm pixel patches) gathered with
  vmapped dynamic_slice.
* Matching = ONE [K, K] descriptor cosine-similarity matmul + mutual
  nearest-neighbour + ratio test. This is the matmul-shaped formulation of
  matching: no loops, no trees.
* Closed-form 2D rigid alignment (Umeyama/Procrustes) of matched keypoint
  coordinates -> a relative SE2 measurement with a match-count-scaled
  information matrix, ready to feed the incremental pose-graph engine
  (core/online.OnlineOptimizer) as EDGE_SE2 constraints.

`frontend_slam_demo` wires it end to end on synthetic imagery: a textured
world rendered under an SE2 trajectory, frames matched consecutively (plus
periodic loop closures), the resulting pose graph optimized online, ATE
reported against ground truth.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["shi_tomasi_scores", "detect_keypoints", "extract_descriptors",
           "match_descriptors", "relative_se2_from_matches",
           "render_frame", "frontend_slam_demo"]


def _conv2(img, kernel):
    """Same-padding 2D convolution of a single-channel image [H, W]."""
    out = lax.conv_general_dilated(
        img[None, None], kernel[None, None].astype(img.dtype),
        window_strides=(1, 1), padding="SAME")
    return out[0, 0]


_SOBEL_X = jnp.array([[-1.0, 0.0, 1.0],
                      [-2.0, 0.0, 2.0],
                      [-1.0, 0.0, 1.0]]) / 8.0
_SOBEL_Y = _SOBEL_X.T


def shi_tomasi_scores(img, window: int = 3):
    """Min-eigenvalue corner response (Shi-Tomasi 'good features to track').

    Structure tensor M = box_window([Ix^2, IxIy; IxIy, Iy^2]); the score is
    the closed-form smaller eigenvalue (A+B-sqrt((A-B)^2+4C^2))/2 — pure
    convolutions + elementwise math, no per-pixel branching.
    """
    ix = _conv2(img, _SOBEL_X)
    iy = _conv2(img, _SOBEL_Y)
    box = jnp.ones((window, window)) / (window * window)
    a = _conv2(ix * ix, box)
    b = _conv2(iy * iy, box)
    c = _conv2(ix * iy, box)
    return 0.5 * (a + b - jnp.sqrt((a - b) ** 2 + 4.0 * c * c))


@partial(jax.jit, static_argnames=("max_kp", "nms_radius", "border"))
def detect_keypoints(img, max_kp: int = 128, nms_radius: int = 4,
                     border: int = 12, min_score: float = 1e-4):
    """Top-k NMS'd Shi-Tomasi keypoints with static output shapes.

    Returns (yx [max_kp, 2] int32, score [max_kp], valid [max_kp] bool).
    Slots past the number of true detections are masked invalid.
    """
    score = shi_tomasi_scores(img)
    h, w = img.shape
    # suppress non-maxima: keep pixels equal to their neighborhood max
    k = 2 * nms_radius + 1
    local_max = lax.reduce_window(score, -jnp.inf, lax.max, (k, k), (1, 1),
                                  "SAME")
    yy, xx = jnp.mgrid[0:h, 0:w]
    inside = ((yy >= border) & (yy < h - border)
              & (xx >= border) & (xx < w - border))
    keep = (score >= local_max) & (score > min_score) & inside
    masked = jnp.where(keep, score, -jnp.inf)
    flat = masked.reshape(-1)
    top, idx = lax.top_k(flat, max_kp)
    yx = jnp.stack([idx // w, idx % w], axis=1).astype(jnp.int32)
    valid = top > -jnp.inf
    return yx, jnp.where(valid, top, 0.0), valid


@partial(jax.jit, static_argnames=("patch",))
def extract_descriptors(img, yx, patch: int = 8):
    """Orientation-steered zero-mean unit-norm patch descriptors
    [K, patch*patch].

    Each keypoint's dominant gradient direction (box-smoothed Sobel) steers
    the sampling grid, making the descriptor rotation-invariant; sampling is
    one bilinear gather per keypoint (vmapped map_coordinates) — static
    shapes throughout.
    """
    from jax.scipy.ndimage import map_coordinates

    ix = _conv2(img, _SOBEL_X)
    iy = _conv2(img, _SOBEL_Y)
    box = jnp.ones((5, 5)) / 25.0
    gx = _conv2(ix, box)
    gy = _conv2(iy, box)

    half = patch / 2.0
    oy, ox = jnp.mgrid[0:patch, 0:patch]
    oy = (oy - half + 0.5) * 1.0
    ox = (ox - half + 0.5) * 1.0

    def one(p):
        a = jnp.arctan2(gy[p[0], p[1]], gx[p[0], p[1]])
        c, s = jnp.cos(a), jnp.sin(a)
        # rotate the sampling grid by the keypoint orientation
        ry = p[0] + c * oy + s * ox
        rx = p[1] - s * oy + c * ox
        tile = map_coordinates(img, [ry.reshape(-1), rx.reshape(-1)],
                               order=1, mode="nearest")
        v = tile - tile.mean()
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-6)

    return jax.vmap(one)(yx)


@jax.jit
def match_descriptors(d0, d1, valid0, valid1, min_sim: float = 0.6,
                      ratio: float = 0.95):
    """Mutual-NN + ratio-test matching as one cosine-similarity matmul.

    Returns (idx1 [K0] int32 — the match of each kp0 in kp1, ok [K0] bool).
    """
    sim = d0 @ d1.T                                     # [K0, K1] matmul
    neg = -jnp.inf
    sim = jnp.where(valid0[:, None] & valid1[None, :], sim, neg)
    best1 = jnp.argmax(sim, axis=1)                     # kp0 -> kp1
    best0 = jnp.argmax(sim, axis=0)                     # kp1 -> kp0
    k0 = jnp.arange(d0.shape[0])
    mutual = best0[best1] == k0
    top = jnp.max(sim, axis=1)
    # Lowe ratio test on cosine similarity: the runner-up must be clearly
    # worse than the best (second < ratio * top; top > min_sim > 0)
    sim_wo = jnp.where(jax.nn.one_hot(best1, d1.shape[0], dtype=bool),
                       neg, sim)
    second = jnp.max(sim_wo, axis=1)
    ok = mutual & (top > min_sim) & (second < ratio * top)
    ok = ok & valid0
    return best1.astype(jnp.int32), ok


def relative_se2_from_matches(xy0, xy1, ok, px_per_m: float = 1.0,
                              center=(0.0, 0.0)):
    """Closed-form rigid 2D alignment of matched keypoint coordinates
    (Procrustes/Umeyama, host numpy): returns (se2 [dx, dy, dtheta] mapping
    frame0 -> frame1 camera motion, n_inliers).

    Pixel coordinates are (y, x) and must be centered on the optical axis:
    pass center=(h/2, w/2) for a centered orthographic camera (rotation is
    about the image center; uncentered coords alias rotation into
    translation). Metric scale via px_per_m. One robust trim pass drops the
    worst 20% residuals (a cheap RANSAC stand-in for synthetic imagery).
    """
    m0 = np.asarray(xy0, dtype=np.float64)[np.asarray(ok)] - np.asarray(center)
    m1 = np.asarray(xy1, dtype=np.float64)[np.asarray(ok)] - np.asarray(center)
    if len(m0) < 3:
        return None, 0

    def fit(a, b):
        mu_a, mu_b = a.mean(0), b.mean(0)
        cov = (b - mu_b).T @ (a - mu_a)
        u, _, vt = np.linalg.svd(cov)
        d = np.sign(np.linalg.det(u @ vt))
        rot = u @ np.diag([1.0, d]) @ vt
        t = mu_b - rot @ mu_a
        return rot, t

    # image coords (y, x) -> camera-frame (x, y)
    a = m0[:, ::-1] / px_per_m
    b = m1[:, ::-1] / px_per_m
    rot, t = fit(a, b)
    resid = np.linalg.norm(b - (a @ rot.T + t), axis=1)
    keep = resid <= np.quantile(resid, 0.8)
    if keep.sum() >= 3:
        rot, t = fit(a[keep], b[keep])
    theta = np.arctan2(rot[1, 0], rot[0, 0])
    # the camera moved by the INVERSE of the apparent image motion
    rel = -np.array([t[0], t[1], 0.0])
    c, s = np.cos(-theta), np.sin(-theta)
    rel = np.array([c * rel[0] - s * rel[1] + 0.0,
                    s * rel[0] + c * rel[1] + 0.0, 0.0])
    rel[2] = -theta
    return rel, int(keep.sum())


# ---------------------------------------------------------------------------
# Synthetic end-to-end demo
# ---------------------------------------------------------------------------

def _world_texture(size: int = 1024, seed: int = 0):
    """Random texture with DISTINCTIVE corner-rich structure: filtered noise
    plus sparse random 7x7 stamps of varying amplitude — every feature looks
    different, so descriptors are discriminative (identical blobs would all
    fail the Lowe ratio test against each other)."""
    rng = np.random.default_rng(seed)
    tex = rng.normal(0, 1.0, (size, size))
    # cheap smoothing: two passes of a 5-tap box along each axis
    for _ in range(2):
        for ax in (0, 1):
            tex = sum(np.roll(tex, s, axis=ax) for s in range(-2, 3)) / 5.0
    ys = rng.integers(16, size - 16, 400)
    xs = rng.integers(16, size - 16, 400)
    for y, x in zip(ys, xs):
        stamp = rng.normal(0, 1.0, (7, 7)) * rng.uniform(2.0, 5.0)
        tex[y - 3:y + 4, x - 3:x + 4] += stamp
    return tex.astype(np.float32)


def render_frame(world, pose_se2, frame: int = 160, px_per_m: float = 16.0):
    """Orthographic camera above an SE2 robot: sample the world texture on
    the pose-transformed pixel grid (bilinear map_coordinates — a gather)."""
    from jax.scipy.ndimage import map_coordinates
    h = w = frame
    ys, xs = jnp.mgrid[0:h, 0:w]
    # pixel -> camera-frame metric coords centered on the robot
    cx = (xs - w / 2) / px_per_m
    cy = (ys - h / 2) / px_per_m
    c, s = jnp.cos(pose_se2[2]), jnp.sin(pose_se2[2])
    wx = pose_se2[0] + c * cx - s * cy
    wy = pose_se2[1] + s * cx + c * cy
    # world metric -> texture pixel (texture centered at origin)
    size = world.shape[0]
    ty = wy * px_per_m + size / 2
    tx = wx * px_per_m + size / 2
    return map_coordinates(world, [ty, tx], order=1, mode="nearest")


def frontend_slam_demo(n_frames: int = 24, seed: int = 3, max_kp: int = 96,
                       loop_every: int = 8, verbose: bool = False):
    """End-to-end: render frames along a noisy SE2 loop, detect+match,
    build EDGE_SE2 constraints (consecutive odometry + periodic loop
    closures against frame 0), optimize incrementally, report ATE.

    Returns dict with ate_rmse, ate_rmse_odometry_only (dead reckoning from
    the same front-end measurements without loop closure), n_loop_closures.
    """
    import jax.numpy as jnp
    from openslam_g2o_tpu.core.online import OnlineOptimizer
    from openslam_g2o_tpu.utils.ate import ate_rmse
    from openslam_g2o_tpu.utils import np_lie

    px_per_m = 16.0
    world = jnp.asarray(_world_texture(1024, seed))
    # ground-truth loop trajectory (returns near the start)
    r = 2.2
    gt = []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        gt.append(np.array([r * np.cos(ang) - r, r * np.sin(ang), ang]))

    render = jax.jit(lambda p: render_frame(world, p, px_per_m=px_per_m))
    detect = lambda im: detect_keypoints(im, max_kp=max_kp)
    frames, kps, descs, valids = [], [], [], []
    for k in range(n_frames):
        im = render(jnp.asarray(gt[k]))
        yx, score, valid = detect(im)
        d = extract_descriptors(im, yx)
        frames.append(im)
        kps.append(yx)
        descs.append(d)
        valids.append(valid)

    hw = frames[0].shape
    center = (hw[0] / 2.0, hw[1] / 2.0)

    def measure(i, j):
        idx1, ok = match_descriptors(descs[i], descs[j], valids[i], valids[j])
        xy0 = np.asarray(kps[i])
        xy1 = np.asarray(kps[j])[np.asarray(idx1)]
        rel, n_in = relative_se2_from_matches(xy0, xy1, np.asarray(ok),
                                              px_per_m=px_per_m,
                                              center=center)
        return rel, n_in

    from openslam_g2o_tpu.core.algorithms import LevenbergMarquardtPCG
    oo = OnlineOptimizer(
        algorithm=LevenbergMarquardtPCG(pcg_iters=200, pcg_tol=1e-2),
        iterations_per_solve=3, dtype=jnp.float32)
    oo.add_vertex(0, "se2", np.zeros(3))
    oo.fix(0)
    dead = [np.zeros(3)]
    n_loops = 0
    for k in range(1, n_frames):
        rel, n_in = measure(k - 1, k)
        if rel is None:
            rel, n_in = np.zeros(3), 1
        info = np.diag([1.0, 1.0, 2.0]) * max(n_in, 1) * px_per_m
        oo.add_vertex(k, "se2", None)
        oo.add_edge("edge_se2", (k - 1, k), rel, info)
        dead.append(np_lie.se2_compose(dead[-1], rel))
        if k % loop_every == 0 or k == n_frames - 1:
            lc, n_lc = measure(0, k)
            if lc is not None and n_lc >= 6:
                oo.add_edge("edge_se2", (0, k), lc, info)
                n_loops += 1
            oo.solve()
    oo.solve(iterations=6)

    est = np.stack([oo.estimate(k)[:2] for k in range(n_frames)])
    gt_xy = np.stack([p[:2] for p in gt])
    # ground truth starts at gt[0]; estimates start at the origin — ATE
    # alignment removes the gauge either way
    out = {
        "ate_rmse": float(ate_rmse(est, gt_xy)),
        "ate_rmse_odometry_only": float(ate_rmse(
            np.stack([p[:2] for p in dead]), gt_xy)),
        "n_loop_closures": n_loops,
        "n_frames": n_frames,
    }
    if verbose:
        print(out)
    return out
