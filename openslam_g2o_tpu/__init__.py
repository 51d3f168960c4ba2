"""openslam_g2o_tpu — a JAX framework for sparse nonlinear
least-squares on graphs (SLAM pose graphs, landmark SLAM, bundle adjustment).

A from-scratch re-design of the capability set of g2o (OpenSLAM-org/
openslam_g2o) for JAX/XLA on accelerators: struct-of-array graph specs grouped by
vertex/edge type, vmapped error kernels with forward-mode autodiff on manifold
tangents, batched block Hessian assembly, Schur-complement landmark reduction,
jit-compiled Gauss-Newton / Levenberg-Marquardt / Dogleg outer loops, and
multi-chip scaling via shard_map collectives.
"""
__version__ = "0.1.0"

from openslam_g2o_tpu.core.graph import Graph  # noqa: F401
from openslam_g2o_tpu.core import registry  # noqa: F401

# Importing the model libraries registers their vertex/edge types with the
# global registry (the analogue of g2o's G2O_REGISTER_TYPE static proxies,
# g2o/core/factory.h).
from openslam_g2o_tpu.models import (  # noqa: F401
    slam2d, slam3d, sba, sim3, sclam2d, icp, data, bal, deprecated, target)

from openslam_g2o_tpu.core.algorithms import (  # noqa: F401
    Dogleg, DoglegPCG, GaussNewton, LevenbergMarquardt,
    LevenbergMarquardtPCG, TerminateCriterion, optimize)
from openslam_g2o_tpu.io.g2o_format import load_g2o, loads_g2o, save_g2o  # noqa: F401
