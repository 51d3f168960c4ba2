"""Lane-major block-ELL layout: gather assembly vs scatter fallback vs dense.

The contributor-table (gather) assembly and the scatter fallback must agree
bit-for-bit in f64, and the ELL matvec must reproduce the dense H product on
free slots (the structure is only used under damping + fixed-diag masks)."""
import dataclasses

import numpy as np
import jax.numpy as jnp

from openslam_g2o_tpu.core import problem as P
from openslam_g2o_tpu.core.sparse import (
    assemble_ell, build_ell_pattern, ell_matvec)

rng = np.random.default_rng(17)


def _problem():
    from openslam_g2o_tpu.core.graph import Graph
    from openslam_g2o_tpu.utils import np_lie
    g = Graph()
    n = 30
    info = np.diag([100.0, 100.0, 400.0])
    lm_info = np.eye(2) * 50
    for i in range(n):
        g.add_vertex(i, "se2", rng.normal(0, 1, 3), fixed=(i == 0))
    for i in range(n - 1):
        g.add_edge("edge_se2", (i, i + 1), rng.normal(0, 1, 3), info)
    # loop closures incl. repeated pairs (shared ELL slots)
    for (a, b) in [(0, 10), (5, 20), (5, 20), (3, 29), (0, 10)]:
        g.add_edge("edge_se2", (a, b), rng.normal(0, 1, 3), info)
    for i in range(12):
        g.add_vertex(100 + i, "point_xy", rng.normal(0, 2, 2))
        for j in rng.choice(n, 3, replace=False):
            g.add_edge("edge_se2_xy", (int(j), 100 + i),
                       rng.normal(0, 1, 2), lm_info)
    return g.compile(dtype=jnp.float64)


class TestLaneMajorEll:
    def test_gather_assembly_matches_scatter_fallback(self):
        prob = _problem()
        pattern = build_ell_pattern(prob)
        assert all(c is not None for c in pattern.contrib_idx)
        lin = P.linearize(prob)
        v_fast, b_fast = assemble_ell(prob, pattern, lin)
        fallback = dataclasses.replace(
            pattern,
            contrib_idx=tuple(None for _ in pattern.contrib_idx),
            contrib_mask=tuple(None for _ in pattern.contrib_mask),
            contrib_base=tuple(None for _ in pattern.contrib_base),
            b_idx={k: None for k in pattern.b_idx},
            b_mask={k: None for k in pattern.b_mask},
            b_base={k: None for k in pattern.b_base})
        v_slow, b_slow = assemble_ell(prob, fallback, lin)
        # and the uniform [N*K, M] gather table route (base+overflow off)
        gather_m = dataclasses.replace(
            pattern,
            contrib_base=tuple(None for _ in pattern.contrib_base),
            b_base={k: None for k in pattern.b_base})
        v_tbl, b_tbl = assemble_ell(prob, gather_m, lin)
        for a, b, c in zip(v_fast, v_slow, v_tbl):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-12)
            np.testing.assert_allclose(np.asarray(a), np.asarray(c),
                                       atol=1e-12)
        for k in b_fast:
            np.testing.assert_allclose(np.asarray(b_fast[k]),
                                       np.asarray(b_slow[k]), atol=1e-12)
            np.testing.assert_allclose(np.asarray(b_fast[k]),
                                       np.asarray(b_tbl[k]), atol=1e-12)

    def test_matvec_and_b_match_dense_system(self):
        prob = _problem()
        pattern = build_ell_pattern(prob)
        lin = P.linearize(prob)
        values, b = assemble_ell(prob, pattern, lin)
        H, b_dense, _ = P.build_dense_system(prob, lin=lin,
                                             add_fixed_diag=False)
        # random probe vectors
        for trial in range(3):
            x_flat = rng.normal(size=prob.static.total_dim)
            x_parts = {}
            for g in prob.static.vgroups:
                seg = x_flat[g.offset:g.offset + g.count * g.tangent_dim]
                x_parts[g.name] = jnp.asarray(
                    seg.reshape(g.count, g.tangent_dim))
            y = ell_matvec(prob, pattern, values, x_parts)
            y_flat = np.concatenate(
                [np.asarray(y[g.name]).reshape(-1)
                 for g in prob.static.vgroups])
            np.testing.assert_allclose(y_flat, np.asarray(H) @ x_flat,
                                       atol=1e-9)
        b_flat = np.concatenate(
            [np.asarray(b[g.name]).reshape(-1)
             for g in prob.static.vgroups])
        np.testing.assert_allclose(b_flat, np.asarray(b_dense), atol=1e-9)

    def test_diag_blocks_match_dense(self):
        prob = _problem()
        pattern = build_ell_pattern(prob)
        lin = P.linearize(prob)
        values, _ = assemble_ell(prob, pattern, lin)
        H = np.asarray(P.build_dense_system(prob, lin=lin,
                                            add_fixed_diag=False)[0])
        diag = pattern.diag_blocks(prob, values)
        for g in prob.static.vgroups:
            D = g.tangent_dim
            got = np.asarray(diag[g.name])
            for i in range(g.count):
                off = g.offset + i * D
                np.testing.assert_allclose(got[i], H[off:off + D, off:off + D],
                                           atol=1e-9)


class TestDiagFoldAndScaling:
    """ell_add_diag and ell_scale_jacobi (the split-preconditioner path)
    against dense reference computations."""

    def _problem(self):
        import numpy as np
        from openslam_g2o_tpu.core.graph import Graph
        from openslam_g2o_tpu.utils import np_lie
        rng = np.random.default_rng(7)
        g = Graph()
        n = 12
        poses = [np.array([i * 1.0, 0.1 * rng.normal(), 0.05 * rng.normal()])
                 for i in range(n)]
        info = np.diag([50.0, 60.0, 70.0])
        for i, p in enumerate(poses):
            g.add_vertex(i, "se2", p, fixed=(i == 0))
        for i in range(n - 1):
            z = np_lie.se2_compose(np_lie.se2_inverse(poses[i]), poses[i + 1])
            g.add_edge("edge_se2", (i, i + 1), z + 0.01, info)
        g.add_edge("edge_se2", (n - 1, 0),
                   np_lie.se2_compose(np_lie.se2_inverse(poses[-1]), poses[0]),
                   info)
        return g.compile()

    def test_add_diag_matches_extra_diag_matvec(self):
        import numpy as np
        import jax.numpy as jnp
        from openslam_g2o_tpu.core import problem as P
        from openslam_g2o_tpu.core.sparse import (
            build_ell_pattern, assemble_ell, ell_add_diag, ell_matvec_lane)
        prob = self._problem()
        pattern = build_ell_pattern(prob)
        lin = P.linearize(prob)
        values, b = assemble_ell(prob, pattern, lin)
        lam = 0.37
        extra = {g.name: lam * prob.free[g.name] + (1.0 - prob.free[g.name])
                 for g in prob.static.vgroups}
        folded = ell_add_diag(prob, pattern, values, extra)
        xT = {k: jnp.asarray(np.random.default_rng(1).normal(
            size=v.T.shape)) for k, v in b.items()}
        y1 = ell_matvec_lane(prob, pattern, folded, xT)
        y2 = ell_matvec_lane(prob, pattern, values, xT,
                             extra_diagT={k: jnp.asarray(
                                 np.asarray(extra[k]))[None, :]
                                 for k in extra})
        for k in y1:
            np.testing.assert_allclose(np.asarray(y1[k]), np.asarray(y2[k]),
                                       rtol=1e-5, atol=1e-6)

    def test_scaled_system_solution_matches_direct(self):
        import numpy as np
        import jax.numpy as jnp
        from openslam_g2o_tpu.core import problem as P
        from openslam_g2o_tpu.core.sparse import (
            build_ell_pattern, assemble_ell, ell_add_diag, ell_matvec_lane,
            ell_scale_jacobi, lane_block_mv)
        from openslam_g2o_tpu.core.solvers import (
            batched_chol_inv_lower, pcg_solve)
        prob = self._problem()
        pattern = build_ell_pattern(prob)
        lin = P.linearize(prob)
        values, b = assemble_ell(prob, pattern, lin)
        lam = 0.1
        extra = {g.name: lam * prob.free[g.name] + (1.0 - prob.free[g.name])
                 for g in prob.static.vgroups}
        folded = ell_add_diag(prob, pattern, values, extra)
        diag = pattern.diag_blocks(prob, values)
        eye = jnp.eye(3, dtype=prob.dtype)
        dblocks = {k: diag[k] + np.asarray(extra[k])[:, None, None] * eye[None]
                   for k in diag}
        linv = {k: batched_chol_inv_lower(dblocks[k]) for k in dblocks}
        svals = ell_scale_jacobi(prob, pattern, folded, linv)
        linv_lane = {k: jnp.moveaxis(linv[k], 0, -1) for k in linv}
        bT = {k: v.T for k, v in b.items()}
        bhat = lane_block_mv(linv_lane, bT)
        mv = lambda xT: ell_matvec_lane(prob, pattern, svals, xT)
        xhat, ok = pcg_solve(mv, bhat, max_iter=200, tol=1e-12,
                             norm="precond")
        assert bool(ok)
        dxT = lane_block_mv(linv_lane, xhat, transpose=True)
        # reference: dense damped solve
        H, bd, _ = P.build_dense_system(prob, lin=lin)
        free_t, _ = P.tangent_masks(prob)
        Hd = np.asarray(H) + np.diag(
            lam * np.asarray(free_t) + (1.0 - np.asarray(free_t)))
        dx_ref = np.linalg.solve(Hd, np.asarray(bd))
        dx = np.concatenate([np.asarray(dxT["se2"]).T.reshape(-1)])
        np.testing.assert_allclose(dx, dx_ref, rtol=1e-4, atol=1e-5)


class TestKMajorMatvec:
    """The K-major hot-loop matvec ([Dr*Dc, K, N], N on lanes) must agree
    digit-exactly with the reference [.., N, K] layout, and the Gershgorin
    bound must dominate the true spectral radius."""

    def _system(self):
        import jax.numpy as jnp
        from openslam_g2o_tpu.apps.simulator import Simulator2D
        from openslam_g2o_tpu.core.problem import linearize
        from openslam_g2o_tpu.core.sparse import build_ell_pattern, assemble_ell
        # an intel-sized session: revisits give a few high-degree poses
        g, _ = Simulator2D(seed=1).simulate(943, landmark_obs=False)
        prob = g.compile(dtype=jnp.float64)
        pattern = build_ell_pattern(prob)
        values, b = assemble_ell(prob, pattern, linearize(prob))
        return prob, pattern, values, b

    def test_kmajor_matches_reference_layout(self):
        import numpy as np
        import jax.numpy as jnp
        from openslam_g2o_tpu.core.sparse import (
            ell_matvec_lane, ell_matvec_lane_kmajor, ell_values_to_kmajor)
        prob, pattern, values, _ = self._system()
        rng = np.random.default_rng(2)
        xT = {g.name: jnp.asarray(
            rng.standard_normal((g.tangent_dim, g.count)))
            for g in prob.static.vgroups}
        y0 = ell_matvec_lane(prob, pattern, values, xT)
        vk = ell_values_to_kmajor(prob, pattern, values)
        y1 = ell_matvec_lane_kmajor(prob, pattern, vk, xT)
        for k in y0:
            np.testing.assert_array_equal(np.asarray(y0[k]),
                                          np.asarray(y1[k]))

    def test_tiered_matvec_matches_kmajor(self):
        """base+overflow tier split (ell_split_tiers_kmajor) must reproduce
        the single-table K-major matvec exactly — it is a pure relayout of
        the same gather+reduce, motivated only by gather throughput."""
        import numpy as np
        import jax.numpy as jnp
        from openslam_g2o_tpu.core.sparse import (
            ell_matvec_lane_kmajor, ell_matvec_lane_kmajor_tiered,
            ell_split_tiers_kmajor, ell_values_to_kmajor)
        prob, pattern, values, _ = self._system()
        assert any(r is not None for r in pattern.tier_rows), \
            "the generated session should activate the two-tier split"
        rng = np.random.default_rng(3)
        xT = {g.name: jnp.asarray(
            rng.standard_normal((g.tangent_dim, g.count)))
            for g in prob.static.vgroups}
        vk = ell_values_to_kmajor(prob, pattern, values)
        y0 = ell_matvec_lane_kmajor(prob, pattern, vk, xT)
        tiers = ell_split_tiers_kmajor(prob, pattern, vk)
        y1 = ell_matvec_lane_kmajor_tiered(prob, pattern, tiers, xT)
        for k in y0:
            np.testing.assert_allclose(np.asarray(y0[k]), np.asarray(y1[k]),
                                       rtol=1e-12, atol=1e-12)

    def test_gershgorin_dominates_power_iteration(self):
        import numpy as np
        import jax.numpy as jnp
        from openslam_g2o_tpu.core.sparse import (
            ell_matvec_lane, ell_gershgorin_bound)
        from openslam_g2o_tpu.core.solvers import _tree_dot
        prob, pattern, values, _ = self._system()
        hi = float(ell_gershgorin_bound(prob, pattern, values))
        rng = np.random.default_rng(3)
        x = {g.name: jnp.asarray(
            rng.standard_normal((g.tangent_dim, g.count)))
            for g in prob.static.vgroups}
        for _ in range(30):
            y = ell_matvec_lane(prob, pattern, values, x)
            nrm = jnp.sqrt(_tree_dot(y, y))
            x = {k: v / nrm for k, v in y.items()}
        lmax = float(_tree_dot(x, ell_matvec_lane(prob, pattern, values, x))
                     / _tree_dot(x, x))
        assert hi >= lmax > 0


class TestDiaSplit:
    def test_dia_activates_on_serpentine_and_matches_plain_matvec(self):
        """On the serpentine 100k-generator shape (odometry +-1, closure
        +-sweep, self 0) the DIA band split must activate and reproduce
        the plain K-major matvec exactly."""
        import jax.numpy as jnp
        from openslam_g2o_tpu.apps.simulator import synthetic_pose_graph_2d
        from openslam_g2o_tpu.core.problem import linearize
        from openslam_g2o_tpu.core.sparse import (
            assemble_ell, build_ell_pattern, ell_matvec_lane_kmajor,
            ell_matvec_lane_kmajor_hot, ell_split_hot_kmajor,
            ell_values_to_kmajor)

        prob, _ = synthetic_pose_graph_2d(n_poses=1500, grid=15,
                                          dtype=jnp.float64)
        pattern = build_ell_pattern(prob)
        assert pattern.dia_offsets[0] is not None
        assert 0 in pattern.dia_offsets[0]
        assert 1 in pattern.dia_offsets[0] and -1 in pattern.dia_offsets[0]
        values, _ = assemble_ell(prob, pattern, linearize(prob))
        vk = ell_values_to_kmajor(prob, pattern, values)
        rng = np.random.default_rng(3)
        xT = {g.name: jnp.asarray(rng.normal(size=(g.tangent_dim, g.count)))
              for g in prob.static.vgroups}
        y_plain = ell_matvec_lane_kmajor(prob, pattern, vk, xT)
        split = ell_split_hot_kmajor(prob, pattern, vk)
        y_hot = ell_matvec_lane_kmajor_hot(prob, pattern, split, xT)
        for k in y_plain:
            np.testing.assert_allclose(np.asarray(y_hot[k]),
                                       np.asarray(y_plain[k]),
                                       rtol=1e-12, atol=1e-12)

    def test_hot_matvec_matches_on_irregular_graph(self):
        """Random-topology graph (DIA may or may not activate): the hot
        dispatcher must agree with the plain matvec either way."""
        import jax.numpy as jnp
        from tests.test_graph_problem import make_se2_chain
        from openslam_g2o_tpu.core.problem import linearize
        from openslam_g2o_tpu.core.sparse import (
            assemble_ell, build_ell_pattern, ell_matvec_lane_kmajor,
            ell_matvec_lane_kmajor_hot, ell_split_hot_kmajor,
            ell_values_to_kmajor)

        g, _ = make_se2_chain(n=40, noise=0.1)
        # extra irregular closures
        rng = np.random.default_rng(5)
        info = np.diag([50.0, 50.0, 90.0])
        for _ in range(25):
            i, j = sorted(rng.integers(0, 40, 2).tolist())
            if i == j:
                continue
            g.add_edge("edge_se2", (i, j), np.zeros(3), info)
        prob = g.compile(dtype=jnp.float64)
        pattern = build_ell_pattern(prob)
        values, _ = assemble_ell(prob, pattern, linearize(prob))
        vk = ell_values_to_kmajor(prob, pattern, values)
        xT = {gr.name: jnp.asarray(
            rng.normal(size=(gr.tangent_dim, gr.count)))
            for gr in prob.static.vgroups}
        y_plain = ell_matvec_lane_kmajor(prob, pattern, vk, xT)
        split = ell_split_hot_kmajor(prob, pattern, vk)
        y_hot = ell_matvec_lane_kmajor_hot(prob, pattern, split, xT)
        for k in y_plain:
            np.testing.assert_allclose(np.asarray(y_hot[k]),
                                       np.asarray(y_plain[k]),
                                       rtol=1e-12, atol=1e-12)


class TestHotAssembly:
    """Round-5 DIA-direct assembly: assemble_hot and the hot_* per-trial
    pipeline must reproduce the proven assemble_ell -> kmajor -> split
    pipeline bit-for-bit in f64, on DIA-active and fallback graphs alike."""

    def _parity(self, prob, pattern, edge_valid_note=""):
        import jax.numpy as jnp
        from openslam_g2o_tpu.core.problem import linearize
        from openslam_g2o_tpu.core.solvers import batched_chol_inv_lower
        from openslam_g2o_tpu.core.sparse import (
            assemble_hot, ell_add_diag_kmajor, ell_gershgorin_bound,
            ell_matvec_lane_kmajor_hot, ell_scale_jacobi_kmajor,
            ell_split_hot_kmajor, ell_values_to_kmajor, hot_add_diag,
            hot_diag_blocks, hot_gershgorin_bound, hot_scale_jacobi,
            hot_split)

        lin = linearize(prob)
        values, b_old = assemble_ell(prob, pattern, lin)
        hot, b_new = assemble_hot(prob, pattern, lin)
        for k in b_old:
            np.testing.assert_allclose(np.asarray(b_new[k]),
                                       np.asarray(b_old[k]),
                                       rtol=1e-12, atol=1e-12)
        vk = ell_values_to_kmajor(prob, pattern, values)
        r = np.random.default_rng(11)
        xT = {g.name: jnp.asarray(r.normal(size=(g.tangent_dim, g.count)))
              for g in prob.static.vgroups}
        y_old = ell_matvec_lane_kmajor_hot(
            prob, pattern, ell_split_hot_kmajor(prob, pattern, vk), xT)
        y_new = ell_matvec_lane_kmajor_hot(
            prob, pattern, hot_split(prob, pattern, hot), xT)
        for k in y_old:
            np.testing.assert_allclose(np.asarray(y_new[k]),
                                       np.asarray(y_old[k]),
                                       rtol=1e-12, atol=1e-12)
        db_old = pattern.diag_blocks(prob, values)
        db_new = hot_diag_blocks(prob, pattern, hot)
        for k in db_old:
            np.testing.assert_allclose(np.asarray(db_new[k]),
                                       np.asarray(db_old[k]),
                                       rtol=1e-12, atol=1e-12)
        # damped + Jacobi-scaled trial pipeline parity
        extra = {g.name: 0.23 * prob.free[g.name]
                 + (1.0 - prob.free[g.name])
                 for g in prob.static.vgroups}
        eyes = {g.name: jnp.eye(g.tangent_dim, dtype=prob.dtype)
                for g in prob.static.vgroups}
        dblocks = {n: db_old[n] + extra[n][:, None, None] * eyes[n][None]
                   for n in db_old}
        linv = {n: batched_chol_inv_lower(dblocks[n]) for n in dblocks}
        sv_old = ell_scale_jacobi_kmajor(
            prob, pattern, ell_add_diag_kmajor(prob, pattern, vk, extra),
            linv)
        sv_new = hot_scale_jacobi(
            prob, pattern, hot_add_diag(prob, pattern, hot, extra), linv)
        yo = ell_matvec_lane_kmajor_hot(
            prob, pattern, ell_split_hot_kmajor(prob, pattern, sv_old), xT)
        yn = ell_matvec_lane_kmajor_hot(
            prob, pattern, hot_split(prob, pattern, sv_new), xT)
        for k in yo:
            np.testing.assert_allclose(np.asarray(yn[k]),
                                       np.asarray(yo[k]),
                                       rtol=1e-12, atol=1e-12)
        gb_old = ell_gershgorin_bound(prob, pattern, sv_old, kmajor=True)
        gb_new = hot_gershgorin_bound(prob, pattern, sv_new)
        assert float(gb_new) >= float(gb_old) * (1 - 1e-12), edge_valid_note

    def test_dia_direct_assembly_on_serpentine(self):
        import jax.numpy as jnp
        from openslam_g2o_tpu.apps.simulator import synthetic_pose_graph_2d
        from openslam_g2o_tpu.core.sparse import build_ell_pattern

        prob, _ = synthetic_pose_graph_2d(n_poses=1500, grid=15,
                                          dtype=jnp.float64)
        pattern = build_ell_pattern(prob)
        assert pattern.dia_asm[0] is not None, \
            "DIA-direct assembly tables did not build on the serpentine"
        Ms, Mo, Mr, m_off, has_self = pattern.dia_asm_m[0]
        assert has_self and Ms >= 2 and Mo == 1
        self._parity(prob, pattern)

    def test_hot_assembly_on_mixed_group_graph(self):
        pattern_prob = _problem()
        from openslam_g2o_tpu.core.sparse import build_ell_pattern
        pattern = build_ell_pattern(pattern_prob)
        self._parity(pattern_prob, pattern)

    def test_hot_assembly_with_edge_valid_masks(self):
        """The online engine's bucket-padding exclusion (edge_valid) must
        compose with DIA-direct assembly: padding edges' contributions are
        dropped from every contributor table."""
        import jax.numpy as jnp
        from openslam_g2o_tpu.apps.simulator import synthetic_pose_graph_2d
        from openslam_g2o_tpu.core.sparse import build_ell_pattern

        prob, _ = synthetic_pose_graph_2d(n_poses=900, grid=10,
                                          dtype=jnp.float64)
        key = prob.static.egroups[0].key
        E = prob.edges[key].measurement.shape[0]
        valid = np.ones(E, dtype=bool)
        valid[-E // 10:] = False
        # zero the information of invalid edges so both paths agree
        import dataclasses as dc
        ea = prob.edges[key]
        info = np.asarray(ea.information).copy()
        info[~valid] = 0.0
        prob = dc.replace(prob, edges={key: dc.replace(
            ea, information=jnp.asarray(info))})
        pattern = build_ell_pattern(prob, edge_valid={key: valid})
        self._parity(prob, pattern, "edge_valid")
