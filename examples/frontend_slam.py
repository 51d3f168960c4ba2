"""End-to-end front-end demo: synthetic imagery -> detect + match ->
EDGE_SE2 constraints -> incremental optimization -> ATE report.

The reference has no front-end (g2o consumes constraint graphs); this
demonstrates the end-to-end front-end configuration of the roadmap
(ROADMAP.md) on the JAX pipeline (apps/frontend.py): conv Shi-Tomasi detection, orientation-steered patch
descriptors, one-matmul mutual-NN matching, closed-form relative SE2, and
the incremental OnlineOptimizer closing the loop.

Run: python examples/frontend_slam.py [--frames 24]
"""
import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--seed", type=int, default=3)
    args = p.parse_args(argv)

    from openslam_g2o_tpu.apps.frontend import frontend_slam_demo
    out = frontend_slam_demo(n_frames=args.frames, seed=args.seed,
                             verbose=False)
    print(f"frames:               {out['n_frames']}")
    print(f"loop closures:        {out['n_loop_closures']}")
    print(f"ATE RMSE (optimized): {out['ate_rmse']:.4f} m")
    print(f"ATE RMSE (odometry):  {out['ate_rmse_odometry_only']:.4f} m")
    assert out["ate_rmse"] <= out["ate_rmse_odometry_only"]
    return out


if __name__ == "__main__":
    main()
