"""Schur-path marginal covariance vs the dense reference path.

Methodology: the dense path (compute_marginals_all_diagonal) inverts the full
H via dense Cholesky — exact but O(T^3) in the TOTAL dim, untenable for BA.
The Schur path must reproduce it digit-close on a problem small enough to run
both (marginal_covariance_cholesky.h:50-103 parity)."""
import numpy as np
import jax.numpy as jnp
import pytest

from openslam_g2o_tpu.core.marginals import (
    compute_marginals_all_diagonal, compute_marginals_schur)
from tests.test_ba import make_ba_scene


class TestSchurMarginals:
    def test_matches_dense_on_small_ba(self):
        g, _, _ = make_ba_scene(n_cams=5, n_points=25, pixel_noise=0.5)
        g.set_fixed(1, True)      # pin the monocular scale gauge too
        prob = g.compile(dtype=jnp.float64)
        dense = compute_marginals_all_diagonal(prob)
        schur = compute_marginals_schur(prob)
        assert set(dense) == set(schur)
        for name in dense:
            assert np.isfinite(np.asarray(dense[name])).all(), name
            assert np.isfinite(np.asarray(schur[name])).all(), name
            np.testing.assert_allclose(
                np.asarray(schur[name]), np.asarray(dense[name]),
                rtol=1e-7, atol=1e-10, err_msg=name)

    def test_fixed_vertices_zero_covariance(self):
        g, _, _ = make_ba_scene(n_cams=5, n_points=25)
        g.set_fixed(1, True)
        prob = g.compile(dtype=jnp.float64)
        schur = compute_marginals_schur(prob)
        np.testing.assert_allclose(np.asarray(schur["se3_expmap"][0]), 0.0)

    def test_with_pose_pose_edges(self):
        # add odometry edges between consecutive cameras -> Hpp_extra path
        g, _, cams = make_ba_scene(n_cams=5, n_points=25)
        from openslam_g2o_tpu.utils import np_lie
        info = np.eye(6) * 10.0
        for i in range(4):
            z = np_lie.se3_compose(cams[i + 1], np_lie.se3_inverse(cams[i]))
            g.add_edge("edge_se3_expmap", (i, i + 1), z, info)
        prob = g.compile(dtype=jnp.float64)
        dense = compute_marginals_all_diagonal(prob)
        schur = compute_marginals_schur(prob)
        for name in dense:
            np.testing.assert_allclose(
                np.asarray(schur[name]), np.asarray(dense[name]),
                rtol=1e-7, atol=1e-10, err_msg=name)

    def test_tiled_fallback_matches_b2_route(self):
        """The B2-matmul route (dense_schur_ok shapes) and the tiled
        K x K neighbor-pair fallback (beyond-gate shapes) are different
        assemblies of the same identity — force both on one problem."""
        import openslam_g2o_tpu.core.ba_ell as BE
        import openslam_g2o_tpu.core.marginals as M
        g, _, _ = make_ba_scene(n_cams=6, n_points=20)
        g.set_fixed(1, True)
        prob = g.compile(dtype=jnp.float64)
        full = compute_marginals_schur(prob)          # B2 route
        orig_tp = BE._DENSE_SCHUR_MAX_TP
        orig_tiles = M._pair_tiles
        try:
            BE._DENSE_SCHUR_MAX_TP = 0                # gate off -> tiled
            M._pair_tiles = lambda K, tile=2: orig_tiles(K, 2)
            tiled = compute_marginals_schur(prob)
        finally:
            BE._DENSE_SCHUR_MAX_TP = orig_tp
            M._pair_tiles = orig_tiles
        for name in full:
            np.testing.assert_allclose(np.asarray(tiled[name]),
                                       np.asarray(full[name]),
                                       rtol=1e-9, atol=1e-12)

    def test_compute_marginals_auto_routes_ba(self):
        g, _, _ = make_ba_scene(n_cams=5, n_points=25)
        g.set_fixed(1, True)
        prob = g.compile(dtype=jnp.float64)
        from openslam_g2o_tpu.core.marginals import compute_marginals
        via_auto = compute_marginals(prob, g, [2, 1002])
        via_dense = compute_marginals(prob, g, [2, 1002], method="dense")
        for vid in (2, 1002):
            np.testing.assert_allclose(via_auto[vid], via_dense[vid],
                                       rtol=1e-7, atol=1e-10)
