"""Dogleg trust-region tests: dense vs matrix-free-PCG parity and the
factory/CLI reachability of dl_var_pcg.

The reference runs Dogleg on any linear-solver backend through
BlockSolverBase::multiplyHessian (block_solver.h:90); the JAX re-design
pairs the dense `_dogleg_step` with `_dogleg_pcg_step` on the block-ELL
pattern (optimization_algorithm_dogleg.cpp:57-229 semantics in both)."""
import numpy as np
import jax.numpy as jnp

from openslam_g2o_tpu.core.algorithms import Dogleg, DoglegPCG, optimize
from openslam_g2o_tpu.core.factory import construct_algorithm
from tests.test_graph_problem import make_se2_chain


def _run(algo, prob, iters):
    traj = []
    state = algo.init(prob)
    for _ in range(iters):
        state, info = algo.step(prob, state)
        traj.append(info["chi2"])
    return traj


class TestDoglegPCG:
    def test_dense_dogleg_converges(self):
        g, _ = make_se2_chain(n=10, noise=0.08)
        prob = g.compile(dtype=jnp.float64)
        traj = _run(Dogleg(), prob, 10)
        assert traj[-1] < 1e-6 or traj[-1] < 0.01 * traj[0]

    def test_pcg_dogleg_matches_dense_trajectory(self):
        """With a tight forcing tolerance h_gn is numerically the exact GN
        step, so the PCG Dogleg must walk the dense Dogleg's chi2
        trajectory (same blend, same trust-radius updates)."""
        g, _ = make_se2_chain(n=12, noise=0.08)
        prob = g.compile(dtype=jnp.float64)
        t_dense = _run(Dogleg(), prob, 6)
        t_pcg = _run(DoglegPCG(pcg_iters=500, pcg_tol=1e-12), prob, 6)
        for cd, cp in zip(t_dense, t_pcg):
            assert abs(cd - cp) <= 1e-6 + 1e-3 * abs(cd)

    def test_pcg_dogleg_converges_from_rough_init(self):
        g, _ = make_se2_chain(n=20, noise=0.2)
        prob = g.compile(dtype=jnp.float64)
        out, stats = optimize(prob, DoglegPCG(pcg_iters=300, pcg_tol=1e-10),
                              iterations=15)
        assert stats[-1]["chi2"] < 0.01 * stats[0]["chi2"] + 1e-6

    def test_factory_resolves_dl_var_pcg(self):
        spec = construct_algorithm("dl_var_pcg")
        algo = spec.make()
        assert isinstance(algo, DoglegPCG)
        # pcg knobs are accepted properties on this spec (CLI
        # -solverProperties filtering goes through accepted_props)
        accepted = spec.accepted_props()
        assert {"pcg_iters", "pcg_tol", "initial_delta"} <= accepted

    def test_dl_var_pcg_via_cli(self, tmp_path, capsys):
        from openslam_g2o_tpu.apps import cli
        from openslam_g2o_tpu.io.g2o_format import save_g2o
        g, _ = make_se2_chain(n=8, noise=0.1)
        path = tmp_path / "chain.g2o"
        save_g2o(g, str(path))
        out = tmp_path / "out.g2o"
        rc = cli.main(["-solver", "dl_var_pcg", "-i", "8",
                       "-o", str(out), str(path)])
        assert rc == 0
        assert out.exists()
