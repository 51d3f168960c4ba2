"""Dual-ELL (scatter-free) Schur solver tests."""
import numpy as np
import pytest

from openslam_g2o_tpu.core import problem as P
from openslam_g2o_tpu.core.algorithms import optimize
from openslam_g2o_tpu.core.ba import LevenbergMarquardtSchur
from openslam_g2o_tpu.core.ba_ell import (
    LevenbergMarquardtSchurELL, build_ba_ell_pattern)


class TestDualEll:
    def test_converges_to_same_minimum_as_general_schur(self):
        from tests.test_ba import make_ba_scene
        g, _, _ = make_ba_scene(n_cams=6, n_points=50, pixel_noise=0.3)
        prob = g.compile()
        _, s1 = optimize(prob, LevenbergMarquardtSchur(), iterations=8)
        _, s2 = optimize(prob, LevenbergMarquardtSchurELL(), iterations=8)
        np.testing.assert_allclose(s2[-1]["chi2"], s1[-1]["chi2"], rtol=1e-6)

    def test_pattern_tables_cover_all_edges(self):
        from tests.test_ba import make_ba_scene
        g, _, _ = make_ba_scene(n_cams=5, n_points=30)
        prob = g.compile()
        pat = build_ba_ell_pattern(prob)
        (pg,) = pat.proj
        E = prob.edges[pg.egkey].measurement.shape[0]
        assert float(pg.lm_mask.sum()) == E
        assert float(pg.cam_mask.sum()) == E
        # every edge id appears exactly once per table
        lm_ids = np.asarray(pg.lm_edge_idx)[np.asarray(pg.lm_mask) > 0]
        cam_ids = np.asarray(pg.cam_edge_idx)[np.asarray(pg.cam_mask) > 0]
        assert sorted(lm_ids.tolist()) == list(range(E))
        assert sorted(cam_ids.tolist()) == list(range(E))

    def test_with_pose_pose_edges(self):
        """Camera odometry edges go through the dense-extra path."""
        from tests.test_ba import make_ba_scene
        import jax.numpy as jnp
        from openslam_g2o_tpu.ops import lie
        from openslam_g2o_tpu.utils import np_lie
        g, _, cams = make_ba_scene(n_cams=6, n_points=40, pixel_noise=0.2)
        info = np.eye(6) * 1000
        for i in range(5):
            z = np_lie.se3_compose(cams[i + 1], np_lie.se3_inverse(cams[i]))
            # EdgeSE3Expmap: log(T2^-1 Z T1) with T world-to-cam
            g.add_edge("edge_se3_expmap", (i, i + 1), z, info)
        prob = g.compile()
        _, s1 = optimize(prob, LevenbergMarquardtSchur(), iterations=8)
        _, s2 = optimize(prob, LevenbergMarquardtSchurELL(), iterations=8)
        np.testing.assert_allclose(s2[-1]["chi2"], s1[-1]["chi2"],
                                   rtol=1e-5, atol=1e-6)

    def test_rejects_multi_landmark_edges(self):
        from openslam_g2o_tpu.core.graph import Graph
        g = Graph()
        g.add_vertex(0, "se2", [0, 0, 0], fixed=True)
        g.add_vertex(1, "point_xy", [1, 1])
        g.add_vertex(2, "se2", [1, 0, 0])
        g.add_edge("edge_se2_xy_calib", (0, 1, 2), [1, 1], np.eye(2))
        with pytest.raises(ValueError):
            build_ba_ell_pattern(g.compile())


class TestHostTrialDispatch:
    """Multi-bucket patterns route through the host-driven trial loop
    (ba_ell_step -> _lm_ba_ell_step_host — the lax.while_loop workaround,
    see ba_ell._BUCKET_ENABLE) and must reproduce the fused step's LM
    semantics: same accepted chi2 trajectory."""

    def test_host_loop_matches_fused_step(self, monkeypatch):
        import openslam_g2o_tpu.core.ba_ell as ba_ell
        from tests.test_ba import make_ba_scene
        from openslam_g2o_tpu.core.ba_ell import (
            ba_ell_step, _lm_ba_ell_step, _wants_host_trials)
        import jax.numpy as jnp
        from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem
        # nearest-camera visibility gives a skewed camera-degree histogram
        prob, _ = synthetic_bal_problem(n_cams=24, n_points=400,
                                        obs_per_point=3, dtype=jnp.float64)
        algo = LevenbergMarquardtSchurELL(pcg_iters=60)
        st = algo.init(prob)
        args = (st["params"], st["lam"], st["ni"], st["chi2"])

        monkeypatch.setattr(ba_ell, "_DENSE_SCHUR_MAX_TP", -1)
        pat_single = build_ba_ell_pattern(prob)
        assert not _wants_host_trials(pat_single)

        monkeypatch.setattr(ba_ell, "_BUCKET_ENABLE", True)
        monkeypatch.setattr(ba_ell, "_BUCKET_MIN", 4)
        monkeypatch.setattr(ba_ell, "_BUCKET_MIN_ROWS", 2)
        monkeypatch.setattr(ba_ell, "_BUCKET_WASTE", 1.0)
        pat_multi = build_ba_ell_pattern(prob)
        assert _wants_host_trials(pat_multi)

        traj_fused, traj_host = [], []
        sf = args
        sh = args
        for _ in range(4):
            out = _lm_ba_ell_step.__wrapped__(prob, pat_single, *sf,
                                              pcg_iters=60)
            sf = out[:4]
            traj_fused.append(float(out[3]))
            out = ba_ell_step(prob, pat_multi, *sh, pcg_iters=60)
            sh = out[:4]
            traj_host.append(float(out[3]))
        np.testing.assert_allclose(traj_host, traj_fused, rtol=1e-5)


class TestKChunking:
    """The bucketed/chunk-scanned table paths (ba_ell._bucketize with
    _K_CHUNK / _BUCKET_MIN forced small) must match the flat single-bucket
    path — they exist purely to bound gather padding waste and XLA program
    size at BAL scale (see CLAUDE.md compile pathology + the 400k-obs
    camera-degree skew)."""

    def test_bucketed_chunked_matches_flat(self, monkeypatch):
        import openslam_g2o_tpu.core.ba_ell as ba_ell
        from tests.test_ba import make_ba_scene
        from openslam_g2o_tpu.core.ba_ell import _lm_ba_ell_step
        import jax.numpy as jnp

        # 40 points x 8 cams fully observed -> K_c = 40 per camera;
        # _BUCKET_MIN=4 + _K_CHUNK=8 force multiple degree buckets AND the
        # within-bucket chunk scan while K_l=8 stays flat
        g, _, _ = make_ba_scene(n_cams=8, n_points=40, pixel_noise=0.5)
        prob = g.compile()
        algo = LevenbergMarquardtSchurELL(pcg_iters=40)
        st = algo.init(prob)
        args = (st["params"], st["lam"], st["ni"], st["chi2"])

        # pin both runs to the implicit-PCG branch: this test asserts the
        # bucketed tables are arithmetically equivalent to the flat gather,
        # which only holds within one solver (the flat case would otherwise
        # route to the dense-Cholesky fast path)
        monkeypatch.setattr(ba_ell, "_DENSE_SCHUR_MAX_TP", -1)
        pat_flat = build_ba_ell_pattern(prob)
        assert all(len(pg.cam_buckets) == 1 for pg in pat_flat.proj)
        # the unjitted function — a jitted call would hit the jit cache and
        # silently reuse the flat trace despite the monkeypatch
        step = _lm_ba_ell_step.__wrapped__
        out_flat = step(prob, pat_flat, *args, pcg_iters=40)

        monkeypatch.setattr(ba_ell, "_K_CHUNK", 8)
        monkeypatch.setattr(ba_ell, "_BUCKET_MIN", 4)
        # multi-bucket tables are off in production until verified on the
        # GPU (see ba_ell._BUCKET_ENABLE) but must stay numerically verified
        # for the day they are turned on
        monkeypatch.setattr(ba_ell, "_BUCKET_ENABLE", True)
        pat_b = build_ba_ell_pattern(prob)
        assert any(len(pg.cam_buckets) > 1
                   or pg.cam_buckets[0][1].ndim == 3 for pg in pat_b.proj)
        out_b = step(prob, pat_b, *args, pcg_iters=40)

        np.testing.assert_allclose(float(out_b[3]), float(out_flat[3]),
                                   rtol=1e-9)
        for k in out_flat[0]:
            np.testing.assert_allclose(np.asarray(out_b[0][k]),
                                       np.asarray(out_flat[0][k]),
                                       rtol=1e-7, atol=1e-9)


class TestFusedRunner:
    def test_trial_per_iter_matches_while_step_trajectory(self):
        """The loop-free trial-per-iteration fused body must walk the
        while-loop step's trajectory: a rejected trial re-linearizes the
        identical system, so accepted states coincide (round-4 design
        note in ba_ell_optimize_fused)."""
        import jax.numpy as jnp
        from tests.test_ba import make_ba_scene
        from openslam_g2o_tpu.core.ba_ell import (
            ba_ell_optimize_fused, ba_ell_step)
        g, _, _ = make_ba_scene(n_cams=6, n_points=40, pixel_noise=0.4)
        prob = g.compile(dtype=jnp.float64)
        algo = LevenbergMarquardtSchurELL()
        pattern = algo.pattern(prob)
        s0 = algo.init(prob)
        st = (s0["params"], s0["lam"], s0["ni"], s0["chi2"])
        # while-loop step, host-driven: count total TRIALS so the two
        # accountings align
        st_w = st
        trials = 0
        chis_w = []
        while trials < 12:
            out = ba_ell_step(prob, pattern, *st_w, pcg_iters=100,
                              pcg_tol=1e-10)
            st_w = out[:4]
            trials += int(out[4])
            chis_w.append(float(st_w[3]))
        out_t = ba_ell_optimize_fused(prob, pattern, *st, n_iters=trials,
                                      pcg_iters=100, pcg_tol=1e-10)
        assert float(out_t[3]) == pytest.approx(chis_w[-1], rel=1e-8)
