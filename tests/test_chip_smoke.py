"""CPU tests of the GPU smoke run and of the device plumbing around it:
chip_smoke.py refuses to run without a GPU, every phase passes its gate at a
tiny size (a rehearsal of the card run), the compile cache sits where it
should, the peak table knows the H100 and nothing else, the online
optimizer has no CPU-serving path, and the multi-device run reads no file
outside the repo and builds 1-D meshes."""
import builtins
import inspect
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# phase -> kwargs of a tiny rehearsal (the card runs the defaults)
SMALL = {
    "pose_graph_100k": dict(n_poses=3000, grid=20),
    "pcg_step_exact": dict(n_poses=400, grid=10),
    "ba_80k": dict(n_cams=10, n_points=200, obs_per_point=4),
    "ba_400k": dict(n_cams=10, n_points=200, obs_per_point=4),
    "schur_step_exact": dict(n_cams=8, n_points=100, obs_per_point=4),
    "marginals_80k": dict(n_cams=10, n_points=200, obs_per_point=4),
    "incremental": dict(n_poses=200, solve_every=50),
    "cli": dict(n_poses=150, iterations=10),
}


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


class TestRefusesWithoutGPU:
    def test_main_exits_nonzero_on_cpu(self, capsys):
        for argv in ([], ["--four-cards"]):
            assert chip_smoke.main(argv) != 0
            out = capsys.readouterr()
            assert '"ok": true' not in out.out
            assert "needs a GPU" in out.err

    def test_script_exits_nonzero_on_cpu(self):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                              env=_cpu_env(), capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout

    def test_script_alone_exits_nonzero(self, tmp_path):
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = _cpu_env()
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_phase_list_is_the_card_run():
    assert [f.__name__ for f in chip_smoke.PHASES] == [
        "pose_graph_100k", "pcg_step_exact", "ba_80k", "ba_400k",
        "schur_step_exact", "marginals_80k", "incremental", "cli"]


@pytest.mark.parametrize("name", list(SMALL))
def test_phase_rehearsal(name, monkeypatch, tmp_path):
    """Each phase at a tiny size on the CPU passes its own gate."""
    from openslam_g2o_tpu.core import ba_ell as BE
    if name == "ba_400k":
        # force the implicit route and its K-chunk scans at a tiny size
        monkeypatch.setattr(BE, "_DENSE_SCHUR_MAX_TP", 0)
        monkeypatch.setattr(BE, "_K_CHUNK", 4)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    res = chip_smoke.run_phase(getattr(chip_smoke, name), **SMALL[name])
    assert res["ok"], chip_smoke._fmt(res)
    assert np.isfinite(res["value"]) and res["value"] <= res["limit"]


class TestCompileCache:
    def _updates(self, monkeypatch, env_dir=None, configured=None):
        import jax
        from openslam_g2o_tpu.utils import compile_cache as CC
        calls = {}
        fake = types.SimpleNamespace(
            jax_compilation_cache_dir=configured,
            update=lambda k, v: calls.__setitem__(k, v))
        monkeypatch.setattr(jax, "config", fake)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        return CC.enable_persistent_cache(backend="gpu"), calls

    def test_environment_variable_is_honoured(self, monkeypatch, tmp_path):
        path, calls = self._updates(monkeypatch, env_dir=str(tmp_path),
                                    configured=str(tmp_path))
        assert path == str(tmp_path)
        dirs = [v for k, v in calls.items() if k.endswith("cache_dir")]
        assert dirs == [str(tmp_path)]

    def test_default_is_fixed_in_checkout(self, monkeypatch):
        from openslam_g2o_tpu.utils import compile_cache as CC
        path, calls = self._updates(monkeypatch)
        assert path == CC.default_cache_dir() == os.path.join(
            ROOT, ".cache", "xla")
        assert [v for k, v in calls.items() if k.endswith("cache_dir")] \
            == [path]
        again, _ = self._updates(monkeypatch)
        assert again == path
        with open(os.path.join(ROOT, ".gitignore")) as fh:
            assert ".cache/" in fh.read().split()

    def test_caller_configured_dir_is_left_alone(self, monkeypatch):
        path, calls = self._updates(monkeypatch, configured="/elsewhere")
        assert path == "/elsewhere"
        assert not any(k.endswith("cache_dir") for k in calls)

    def test_cpu_backend_sets_nothing(self, monkeypatch):
        from openslam_g2o_tpu.utils import compile_cache as CC
        import jax
        calls = {}
        monkeypatch.setattr(jax, "config", types.SimpleNamespace(
            jax_compilation_cache_dir=None,
            update=lambda k, v: calls.__setitem__(k, v)))
        assert CC.enable_persistent_cache(backend="cpu") is None
        assert calls == {}


class TestPeaks:
    def test_h100_row(self):
        from openslam_g2o_tpu.utils.roofline import chip_peaks
        dev = types.SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3")
        peaks = chip_peaks(dev)
        assert peaks["peak_bf16_flops"] == 989e12
        assert peaks["peak_tf32_flops"] == 495e12
        assert peaks["peak_f32_flops"] == 67e12
        assert peaks["hbm_bytes_per_s"] == 3.35e12

    @pytest.mark.parametrize("kind", ["cpu", "TPU v5 lite",
                                      "NVIDIA A100-SXM4-80GB"])
    def test_unknown_kind_raises(self, kind):
        from openslam_g2o_tpu.utils.roofline import chip_peaks
        with pytest.raises(ValueError):
            chip_peaks(types.SimpleNamespace(device_kind=kind))


class TestOnlineHasNoCpuServing:
    def test_no_warmup_machinery(self):
        from openslam_g2o_tpu.core.online import OnlineOptimizer
        params = inspect.signature(OnlineOptimizer).parameters
        assert "background_warmup" not in params
        for attr in ("drain_warmup", "_submit_compile"):
            assert not hasattr(OnlineOptimizer, attr)
        src = inspect.getsource(OnlineOptimizer._solve_fast)
        assert "default_device" not in src

    def test_solve_stats_have_no_fallback_counter(self):
        import jax.numpy as jnp
        from openslam_g2o_tpu.core.algorithms import LevenbergMarquardtPCG
        from openslam_g2o_tpu.core.online import OnlineOptimizer
        oo = OnlineOptimizer(algorithm=LevenbergMarquardtPCG(pcg_iters=50),
                             dtype=jnp.float32, persistent_cache=False)
        oo.add_vertex(0, "se2", [0.0, 0.0, 0.0])
        oo.add_vertex(1, "se2", [0.9, 0.1, 0.0])
        oo.add_edge("edge_se2", (0, 1), [1.0, 0.0, 0.0], np.eye(3))
        oo.solve()
        assert "cpu_fallback_solves" not in oo.session_stats()
        np.testing.assert_allclose(oo.estimate(1), [1.0, 0.0, 0.0],
                                   atol=1e-4)


def test_dryrun_multichip_1d_meshes_no_outside_files(monkeypatch):
    """dryrun_multichip(4) on the virtual CPU mesh at small sizes: every
    mesh is 1-D over the four devices and no file outside the repo is
    opened (its graphs come from the generators)."""
    import jax
    import __graft_entry__ as ge
    assert len(jax.devices()) >= 4
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(os.path.abspath(str(file)))
        return real_open(file, *a, **kw)
    monkeypatch.setattr(builtins, "open", spy)
    results = ge.dryrun_multichip(4, slam2d_poses=120,
                                  serpentine=(800, 10), ba=(6, 60, 4))
    assert len(results) == 7
    assert all(r["mesh_shape"] == (4,) for r in results)
    assert all(r["single"] is not None for r in results[3:])
    outside = [p for p in opened if not p.startswith(ROOT + os.sep)]
    assert outside == []
