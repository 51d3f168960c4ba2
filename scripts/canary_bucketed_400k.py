"""Canary for the gated multi-bucket (sliced-ELL) BA path.

The degree-bucketed tables (core/ba_ell._bucketize) cut the padded gathers
of the 400k-observation BAL shape, whose camera degrees are skewed (mean
444, max 1768 observations per camera). They are gated off
(_BUCKET_ENABLE = False) until their results on the GPU are shown to match
the CPU's. This script is that check:

    python scripts/canary_bucketed_400k.py

It force-enables bucketing, runs the SAME host-driven LM trial program on
the CPU and on the GPU at the 400k shape, compares the chi2 trajectories
step by step and prints the verdict: ``CANARY PASS`` (the path computes the
same steps; enabling it is then a speed decision for the benchmark) or
``CANARY FAIL``. It records nothing. Run it in its own process: one process
per card.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_STEPS = 4
REL_TOL = 2e-3      # float32 trajectory agreement per step


def run_trajectory(platform: str):
    import jax
    import jax.numpy as jnp
    from openslam_g2o_tpu.apps.simulator import synthetic_bal_problem
    from openslam_g2o_tpu.core import ba_ell as BE

    BE._BUCKET_ENABLE = True
    prob, _ = synthetic_bal_problem(n_cams=900, n_points=50000,
                                    obs_per_point=8, dtype=jnp.float32)
    dev = jax.devices(platform)[0]
    with jax.default_device(dev):
        prob = jax.device_put(prob, dev)
        pattern = BE.build_ba_ell_pattern(prob)
        n_buckets = max(len(pg.cam_buckets) for pg in pattern.proj)
        if n_buckets < 2:
            print(f"[{platform}] pattern built only {n_buckets} bucket(s) — "
                  "bucketing did not activate; check _BUCKET_* knobs")
            return None
        state = BE.LevenbergMarquardtSchurELL().init(prob)
        st = (state["params"], state["lam"], state["ni"], state["chi2"])
        traj = [float(st[3])]
        for i in range(N_STEPS):
            t0 = time.monotonic()
            st = BE.ba_ell_step(prob, pattern, *st, pcg_iters=30,
                                pcg_tol=0.05)[:4]
            traj.append(float(st[3]))
            print(f"[{platform}] step {i}: chi2 {traj[-1]:.1f} "
                  f"({time.monotonic() - t0:.1f} s)", flush=True)
    return traj


def main():
    import jax

    plats = jax.config.jax_platforms
    if plats and "cpu" not in plats.split(","):
        jax.config.update("jax_platforms", plats + ",cpu")
    if jax.devices()[0].platform != "gpu":
        print("no GPU visible — the canary compares the GPU with the CPU")
        return 2
    cpu_traj = run_trajectory("cpu")
    gpu_traj = run_trajectory("gpu")
    if cpu_traj is None or gpu_traj is None:
        return 2
    worst = max(abs(c - g) / max(abs(c), 1.0)
                for c, g in zip(cpu_traj, gpu_traj))
    print(f"cpu trajectory: {[round(c, 1) for c in cpu_traj]}")
    print(f"gpu trajectory: {[round(g, 1) for g in gpu_traj]}")
    print(f"worst per-step relative gap: {worst:.2e} (tol {REL_TOL})")
    if worst <= REL_TOL and gpu_traj[-1] < 0.9 * gpu_traj[0]:
        print("CANARY PASS — the bucketed path computes the same steps on "
              "the GPU as on the CPU")
        return 0
    print("CANARY FAIL — keep _BUCKET_ENABLE = False")
    return 1


if __name__ == "__main__":
    sys.exit(main())
