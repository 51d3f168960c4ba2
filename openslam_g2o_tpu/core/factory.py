"""Optimization-algorithm factory: string names -> configured algorithms.

The analogue of OptimizationAlgorithmFactory
(g2o/core/optimization_algorithm_factory.h:75-140) and the per-backend
registration lists (e.g. solvers/csparse/solver_csparse.cpp:104-124).

Name grammar mirrors the reference: ``{gn|lm|dl}_{var|fixN_M}[_backend]``.
Here the "linear solver backend" distinction collapses: `dense` is the
dense Cholesky (the default — it is the fastest choice far beyond the
sizes where the reference must go sparse), `pcg` is matrix-free block-Jacobi
PCG, and `schur` toggles landmark marginalization (the reference's
-marginalize + fixed-size BlockSolver_6_3 path). Block sizes are inferred
from the graph, so `var` and `fixN_M` names behave identically — both are
accepted for CLI compatibility.
"""
from __future__ import annotations

import re
from typing import Optional

from openslam_g2o_tpu.core.algorithms import (
    Dogleg, DoglegPCG, GaussNewton, LevenbergMarquardt,
    LevenbergMarquardtPCG)
from openslam_g2o_tpu.core.ba import LevenbergMarquardtSchur

__all__ = ["construct_algorithm", "list_algorithms", "AlgorithmSpec"]

_NAME_RE = re.compile(
    r"^(?P<algo>gn|lm|dl)_(?P<blocks>var|fix\d+_\d+|\d+_\d+)"
    r"(?P<backend>_(dense|pcg|csparse|cholmod|eigen|schur))?(_scalar)?$")

_SPECIAL = ("structure_only_2", "structure_only_3", "2dlinear")

_ALGOS = {
    "gn": GaussNewton,
    "lm": LevenbergMarquardt,
    "dl": Dogleg,
}


class _SchurAuto:
    """Marginalizing LM: the scatter-free dual-ELL solver when the problem
    is BA-shaped (binary projection edges), else the general Schur path."""

    name = "lm_schur"

    def __init__(self, **props):
        self._props = props
        self._impl = None

    @staticmethod
    def _filter_props(ctor, props):
        import inspect
        accepted = set(inspect.signature(ctor.__init__).parameters)
        return {k: v for k, v in props.items() if k in accepted}

    def _resolve(self, prob):
        if self._impl is None:
            from openslam_g2o_tpu.core.ba_ell import (
                LevenbergMarquardtSchurELL, build_ba_ell_pattern)
            try:
                build_ba_ell_pattern(prob)
                self._impl = LevenbergMarquardtSchurELL(
                    **self._filter_props(LevenbergMarquardtSchurELL,
                                         self._props))
            except ValueError:
                self._impl = LevenbergMarquardtSchur(
                    **self._filter_props(LevenbergMarquardtSchur,
                                         self._props))
        return self._impl

    def init(self, prob):
        return self._resolve(prob).init(prob)

    def step(self, prob, state):
        return self._impl.step(prob, state)


class AlgorithmSpec:
    def __init__(self, algo_name: str, backend: str, marginalize: bool):
        self.algo_name = algo_name
        self.backend = backend
        self.marginalize = marginalize

    def _target_ctors(self, marginalize: bool = False):
        """The constructor(s) a make() call with these settings can reach —
        used for signature-based property filtering (accepted_props)."""
        if self.algo_name == "structure_only":
            from openslam_g2o_tpu.core.special_solvers import StructureOnly
            return (StructureOnly,)
        if self.algo_name == "2dlinear":
            from openslam_g2o_tpu.core.special_solvers import SolverSlam2DLinear
            return (SolverSlam2DLinear,)
        if (marginalize or self.marginalize) and self.algo_name == "lm":
            from openslam_g2o_tpu.core.ba_ell import LevenbergMarquardtSchurELL
            return (LevenbergMarquardtSchurELL, LevenbergMarquardtSchur)
        if self.backend == "pcg" and self.algo_name == "lm":
            return (LevenbergMarquardtPCG,)
        if self.backend == "pcg" and self.algo_name == "dl":
            return (DoglegPCG,)
        return (_ALGOS[self.algo_name],)

    def accepted_props(self, marginalize: bool = False) -> set:
        """Property names the resolved algorithm's constructor(s) accept.

        Signature inspection replaces parsing TypeError messages: the
        reference likewise silently ignores inapplicable solver properties
        (g2o.cpp:218-226 filters through PropertyMap::updateMapFromString)."""
        import inspect
        names: set = set()
        for ctor in self._target_ctors(marginalize):
            sig = inspect.signature(ctor.__init__)
            for p in sig.parameters.values():
                if p.name == "self" or p.kind == p.VAR_KEYWORD:
                    continue
                names.add(p.name)
        return names

    def make(self, marginalize: bool = False, **props):
        if self.algo_name == "structure_only":
            from openslam_g2o_tpu.core.special_solvers import StructureOnly
            return StructureOnly(**props)
        if self.algo_name == "2dlinear":
            from openslam_g2o_tpu.core.special_solvers import SolverSlam2DLinear
            return SolverSlam2DLinear(**props)
        if (marginalize or self.marginalize) and self.algo_name == "lm":
            return _SchurAuto(**props)
        if self.backend == "pcg" and self.algo_name == "lm":
            return LevenbergMarquardtPCG(**props)
        if self.backend == "pcg" and self.algo_name == "dl":
            return DoglegPCG(**props)
        return _ALGOS[self.algo_name](**props)


def construct_algorithm(name: str) -> AlgorithmSpec:
    """Resolve a g2o-style solver name. Unknown legacy backends (csparse,
    cholmod, eigen) map to the dense solver — same semantics (exact
    factorization), different implementation."""
    if name in ("structure_only_2", "structure_only_3"):
        return AlgorithmSpec("structure_only", "dense", False)
    if name == "2dlinear":
        return AlgorithmSpec("2dlinear", "dense", False)
    m = _NAME_RE.match(name)
    if m is None:
        raise ValueError(
            f"unknown algorithm {name!r}; try e.g. gn_var, lm_var, dl_var, "
            f"lm_fix6_3, lm_var_pcg (see list_algorithms())")
    backend = (m.group("backend") or "_dense").lstrip("_")
    if backend in ("csparse", "cholmod", "eigen"):
        backend = "dense"
    marginalize = m.group("blocks") not in ("var",) and backend != "pcg"
    return AlgorithmSpec(m.group("algo"), backend, marginalize)


def list_algorithms():
    """Registered algorithm names + descriptions (the CLI's -listSolvers)."""
    out = []
    for algo, desc in (("gn", "Gauss-Newton"),
                       ("lm", "Levenberg-Marquardt"),
                       ("dl", "Dogleg")):
        for blocks, bdesc in (("var", "variable blocksize"),
                              ("fix6_3", "SE3+XYZ blocks w/ Schur"),
                              ("fix7_3", "Sim3+XYZ blocks w/ Schur"),
                              ("fix3_2", "SE2+XY blocks w/ Schur")):
            for backend in ("", "_dense", "_pcg"):
                out.append((f"{algo}_{blocks}{backend}",
                            f"{desc}, {bdesc}, "
                            f"{'PCG' if backend == '_pcg' else 'dense Cholesky'}"))
    return out
