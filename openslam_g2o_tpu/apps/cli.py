"""g2o — batch CLI mirroring the reference `g2o` binary.

Re-implements the batch path of apps/g2o_cli/g2o.cpp:101-668 (flags
:131-159, batch flow :534-641): load a .g2o file, choose the optimization
algorithm by name, apply a robust kernel, fix a gauge, optimize, report chi2
per iteration, write stats/summary/output files.

Usage:  python -m openslam_g2o_tpu.apps.cli [options] graph.g2o
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="g2o",
        description="JAX graph optimizer (g2o CLI equivalent)")
    p.add_argument("input", nargs="?", help="input .g2o file")
    p.add_argument("-i", dest="max_iterations", type=int, default=10,
                   help="perform n iterations (default 10)")
    p.add_argument("-v", dest="verbose", action="store_true",
                   help="verbose output of the optimization process")
    p.add_argument("-guess", action="store_true",
                   help="initial guess based on spanning tree")
    p.add_argument("-guessOdometry", action="store_true",
                   help="initial guess based on odometry edges only "
                        "(EstimatePropagatorCostOdometry)")
    p.add_argument("-incremental", action="store_true",
                   help="process the graph incrementally (online re-solves)")
    p.add_argument("-update", type=int, default=10,
                   help="incremental mode: solve every n vertices (default 10)")
    p.add_argument("-solver", default="lm_var",
                   help="specify which solver to use (default lm_var)")
    p.add_argument("-solverProperties", default="",
                   help="set properties of the solver, e.g. initialLambda=0.0001")
    p.add_argument("-robustKernel", default="",
                   help="use this robust error function (Huber, Cauchy, ...)")
    p.add_argument("-robustKernelWidth", type=float, default=-1.0,
                   help="width for the robust kernel")
    p.add_argument("-o", dest="output", default="",
                   help="output final version of the graph")
    p.add_argument("-gnudump", default="",
                   help="dump the graph in gnuplot edge format")
    p.add_argument("-plot", default="",
                   help="render the optimized graph to an image (PNG/SVG)")
    p.add_argument("-stats", default="", help="specify a file for the statistics")
    p.add_argument("-profile", action="store_true",
                   help="print per-phase timings (G2OBatchStatistics analogue)")
    p.add_argument("-summary", default="",
                   help="append a summary of this optimization run to the summary file")
    p.add_argument("-gaugeId", type=int, default=-1, help="force the gauge")
    p.add_argument("-gaugeList", default="",
                   help="set the list of gauges separated by commas without "
                        "spaces, e.g: 1,2,3,4,5")
    p.add_argument("-computeMarginals", action="store_true",
                   help="computes the marginal covariances of something. "
                        "FOR TESTING ONLY")
    p.add_argument("-printSolverProperties", action="store_true",
                   help="print the properties of the solver")
    p.add_argument("-marginalize", action="store_true",
                   help="use the Schur complement to marginalize landmarks")
    p.add_argument("-gainThreshold", type=float, default=1e-6,
                   help="stop when the chi2 gain is below this threshold")
    p.add_argument("-maxIterationsWithGain", type=int, default=0,
                   help="max iterations when using the gain-based termination")
    p.add_argument("-listSolvers", action="store_true", help="list available solvers")
    p.add_argument("-listRobustKernels", action="store_true",
                   help="list available robust kernels")
    p.add_argument("-listTypes", action="store_true", help="list registered types")
    p.add_argument("-renameTypes", default="",
                   help="comma-separated list of oldtag=newtag renames")
    p.add_argument("-f32", action="store_true",
                   help="optimize in float32 (default: float64)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    # defer jax-heavy imports so -list* stays instant
    from openslam_g2o_tpu.core import registry, robust
    from openslam_g2o_tpu.core.factory import construct_algorithm, list_algorithms

    if args.listSolvers:
        for name, desc in list_algorithms():
            print(f"{name:24s} {desc}")
        return 0
    if args.listRobustKernels:
        for name in robust.kernel_names():
            if name != "None":
                print(name)
        return 0
    if args.listTypes:
        for tag, vt in sorted(
                (vt.tag, vt) for vt in registry.registered_vertex_types().values()):
            print(f"{tag:32s} vertex  dim={vt.tangent_dim}")
        for tag, et in sorted(
                (et.tag, et) for et in registry.registered_edge_types().values()):
            print(f"{tag:32s} edge    dim={et.error_dim} "
                  f"vertices={','.join(et.vertex_types)}")
        return 0

    if not args.input:
        print("error: no input file given", file=sys.stderr)
        return 1

    import jax
    import jax.numpy as jnp
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    from openslam_g2o_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()

    from openslam_g2o_tpu.core import problem as P
    from openslam_g2o_tpu.core.algorithms import optimize, TerminateCriterion
    from openslam_g2o_tpu.core.initial_guess import (
        odometry_cost, spanning_tree_initial_guess)
    from openslam_g2o_tpu.io.g2o_format import load_g2o, save_g2o

    renamed = None
    if args.renameTypes:
        renamed = registry.renamed_types_lookup(args.renameTypes)

    try:
        construct_algorithm(args.solver)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    t0 = time.monotonic()
    try:
        graph = load_g2o(args.input, renamed_types=renamed)
    except OSError as e:
        print(f"error: cannot read {args.input}: {e}", file=sys.stderr)
        return 1
    load_time = time.monotonic() - t0
    print(f"Read input from {args.input}", file=sys.stderr)
    print(f"# graph is fixed by node {args.gaugeId}" if args.gaugeId >= 0 else
          "# graph state", file=sys.stderr)

    if graph.num_vertices() == 0:
        print("Graph contains no vertices", file=sys.stderr)
        return 1

    # gauge handling (g2o.cpp:272-304)
    if args.gaugeList:
        # fix every listed vertex; abort when one is missing (g2o.cpp:274-289)
        try:
            gauge_ids = [int(s) for s in args.gaugeList.split(",") if s]
        except ValueError:
            print(f"error: malformed -gaugeList {args.gaugeList!r}",
                  file=sys.stderr)
            return 1
        fixed_ids = []
        for gid in gauge_ids:
            if gid not in graph.vertices:
                print(f"fatal, not found the vertex of id {gid} in the "
                      "gaugeList. Aborting", file=sys.stderr)
                return 1
            graph.set_fixed(gid, True)
            fixed_ids.append(str(gid))
        print(f"Fixing gauges: {' '.join(fixed_ids)}", file=sys.stderr)
    elif args.gaugeId >= 0:
        if args.gaugeId not in graph.vertices:
            print(f"cannot find gauge vertex {args.gaugeId}", file=sys.stderr)
            return 1
        graph.set_fixed(args.gaugeId, True)
    elif graph.gauge_freedom():
        gauge = graph.find_gauge()
        print(f"# setting vertex {gauge} fixed (gauge freedom)", file=sys.stderr)
        graph.set_fixed(gauge, True)

    if args.robustKernel:
        width = args.robustKernelWidth if args.robustKernelWidth > 0 else 1.0
        graph.set_robust_kernel(args.robustKernel, width)
        print(f"# robust kernel {args.robustKernel} width {width}", file=sys.stderr)

    if args.guess or args.guessOdometry:
        cost = odometry_cost if args.guessOdometry else None
        n = spanning_tree_initial_guess(graph, cost_fn=cost)
        print(f"# initial guess: initialized {n} vertices", file=sys.stderr)

    if args.incremental:
        # replay the graph through the online optimizer, solving every
        # -update vertices (the batch path of g2o.cpp:350-532), on the
        # ELL-PCG fast path (padding-masked patterns + fused per-solve
        # programs — core/online.py solve() docstring)
        from openslam_g2o_tpu.core.online import OnlineOptimizer
        from openslam_g2o_tpu.core.algorithms import LevenbergMarquardtPCG
        args.update = max(1, args.update)
        t_inc = time.monotonic()
        oo = OnlineOptimizer(
            algorithm=LevenbergMarquardtPCG(pcg_iters=200, pcg_tol=1e-2),
            dtype=jnp.float32 if args.f32 else jnp.float64)
        n_since = 0
        order = list(graph.vertices.values())
        vrank = {vid: i for i, vid in enumerate(graph.vertices)}
        edges_by_vertex: dict = {}
        for ei, e in enumerate(graph.edges):
            last = max(e.vertex_ids, key=lambda v: vrank[v])
            edges_by_vertex.setdefault(last, []).append(ei)
        for rec in order:
            oo.add_vertex(rec.vid, rec.vtype.name, rec.params)
            if rec.fixed:
                oo.fix(rec.vid)
            for ei in edges_by_vertex.get(rec.vid, []):
                e = graph.edges[ei]
                if all(v in oo.graph.vertices for v in e.vertex_ids):
                    oo.add_edge(e.etype.name, e.vertex_ids, e.measurement,
                                e.information, param_ids=e.param_ids)
            n_since += 1
            if n_since >= args.update:
                oo.solve()
                n_since = 0
        stats = oo.solve(iterations=args.max_iterations)
        print(f"# incremental done in {time.monotonic() - t_inc:.2f} s; "
              f"final chi2 = {stats[-1]['chi2']:.6f}", file=sys.stderr)
        for vid, rec in graph.vertices.items():
            rec.params = oo.graph.vertices[vid].params
        if args.output:
            save_g2o(graph, args.output)
            print(f"Saving {args.output}", file=sys.stderr)
        return 0

    spec = construct_algorithm(args.solver)
    props = {}
    if args.solverProperties:
        for kv in args.solverProperties.split(","):
            k, _, v = kv.partition("=")
            key = {"initialLambda": "initial_lambda",
                   "maxTrialsAfterFailure": "max_trials_after_failure",
                   "initialDelta": "initial_delta",
                   # PCG backend knobs (LinearSolverPCG properties,
                   # linear_solver_pcg.h:62-75): iteration budget and the
                   # inexact-Newton forcing tolerance (relative residual)
                   "pcgIterations": "pcg_iters",
                   "pcgTolerance": "pcg_tol",
                   # degree of the Chebyshev polynomial preconditioner
                   # (solvers.make_chebyshev_precond); 0/1 = plain
                   # Jacobi-scaled CG
                   "pcgChebyshevDegree": "pcg_cheby"}.get(k.strip())
            if key is None:
                print(f"# ignoring unknown solver property {k}", file=sys.stderr)
            elif key in ("pcg_cheby", "pcg_iters", "max_trials_after_failure"):
                # integer-valued knobs: accept "4", "4.0", "4e0" but reject
                # genuine fractions with a clear message (a float degree
                # would otherwise surface as an opaque TypeError inside jit
                # tracing, deep in make_chebyshev_precond)
                fv = float(v)
                if fv != int(fv):
                    print(f"# solver property {k} must be an integer, "
                          f"got {v!r}; ignoring", file=sys.stderr)
                else:
                    props[key] = int(fv)
            else:
                props[key] = float(v) if "." in v or "e" in v.lower() else int(float(v))
    dtype = jnp.float32 if args.f32 else jnp.float64
    prob = graph.compile(dtype=dtype)
    use_schur = ((args.marginalize or spec.marginalize)
                 and len(prob.static.marginalized_groups) == 1
                 and prob.static.pose_dim < prob.static.total_dim)
    # drop properties the chosen algorithm does not take (e.g. pcg knobs on
    # a dense solver) by signature inspection — the reference likewise
    # ignores inapplicable ones (g2o.cpp:218-226)
    accepted = spec.accepted_props(marginalize=use_schur)
    props_use = {k: v for k, v in props.items() if k in accepted}
    for k in sorted(set(props) - set(props_use)):
        print(f"# solver ignores property {k}", file=sys.stderr)
    algorithm = spec.make(marginalize=use_schur, **props_use)
    if args.solverProperties or args.printSolverProperties:
        # printProperties analogue (g2o.cpp:224-226): reference-style
        # property names, values as configured on the algorithm object
        prop_display = {
            "initial_lambda": "initialLambda",
            "max_trials_after_failure": "maxTrialsAfterFailure",
            "initial_delta": "initialDelta",
            "pcg_iters": "pcgIterations",
            "pcg_tol": "pcgTolerance",
            "pcg_cheby": "pcgChebyshevDegree",
            "tau": "tau",
        }
        print(f"# solver properties ({args.solver}):", file=sys.stderr)
        target = getattr(algorithm, "_props", None)
        shown = False
        for attr, disp in prop_display.items():
            val = (target.get(attr) if isinstance(target, dict) and
                   attr in target else getattr(algorithm, attr, None))
            if val is not None:
                print(f"#\t {disp}: {val}", file=sys.stderr)
                shown = True
        if not shown:
            print("#\t (no configurable properties)", file=sys.stderr)
    if use_schur:
        print("# Schur complement: marginalizing "
              f"{prob.static.marginalized_groups[0].name}", file=sys.stderr)
    if hasattr(algorithm, "prepare"):
        # e.g. 2dlinear runs its linear orientation init on the host graph
        algorithm.prepare(graph)
        prob = graph.compile(dtype=dtype)
    chi0 = float(P.chi2(prob))
    print(f"Initial chi2 = {chi0:.6f}", file=sys.stderr)

    if args.profile:
        from openslam_g2o_tpu.core.batch_stats import profile_iteration
        solver_kind = ("schur" if use_schur
                       else "pcg" if spec.backend == "pcg" else "dense")
        prof = profile_iteration(prob, solver_kind)
        print("# profile NOTE: raw time_* values each include the "
              f"per-program dispatch floor ({prof['dispatch_floor']*1e3:.2f}"
              " ms on this backend); read the floor-subtracted time_*_net "
              "fields, whose sum (iteration_total) cross-checks against the "
              "fused one-program step (iteration_fused).", file=sys.stderr)
        for k, v in prof.items():
            print(f"# profile {k} = {v}", file=sys.stderr)

    terminate = TerminateCriterion(gain_threshold=args.gainThreshold,
                                   max_iterations=args.maxIterationsWithGain)
    out, stats = optimize(prob, algorithm, iterations=args.max_iterations,
                          verbose=args.verbose, terminate=terminate)
    final_chi = stats[-1]["chi2"] if stats else chi0

    if args.computeMarginals:
        # g2o.cpp:556-583: the (i, i) diagonal block of every free vertex
        # plus the (prev_free, i) off-diagonal, printed to stderr. The
        # hessianIndex ordering is the poses-first compile order here.
        from openslam_g2o_tpu.core.marginals import compute_marginals_pairs
        free_vids = [vid for vid, rec in graph.vertices.items()
                     if not rec.fixed]
        pairs = []
        for i, vid in enumerate(free_vids):
            pairs.append((vid, vid))
            if i > 0:
                pairs.append((free_vids[i - 1], vid))
        blocks = compute_marginals_pairs(out, graph, pairs)
        np.set_printoptions(precision=6, suppress=True)
        for i, vid in enumerate(free_vids):
            print(f"Vertex id:{vid}", file=sys.stderr)
            print(f"inv block :{vid}, {vid}", file=sys.stderr)
            print(blocks[(vid, vid)], file=sys.stderr)
            if i > 0:
                pv = free_vids[i - 1]
                print(f"inv block :{pv}, {vid}", file=sys.stderr)
                print(blocks[(pv, vid)], file=sys.stderr)

    if args.stats:
        with open(args.stats, "w") as f:
            for s in stats:
                f.write(json.dumps(s) + "\n")
    if args.summary:
        n_edges = graph.num_edges()
        with open(args.summary, "a") as f:
            f.write(json.dumps({
                "filename": args.input,
                "n_vertices": graph.num_vertices(),
                "n_edges": n_edges,
                "load_chi": chi0,
                "final_chi": final_chi,
                "solver": args.solver,
                "iterations": len(stats),
                "load_time": load_time,
                "opt_time": sum(s["time"] for s in stats),
            }) + "\n")
    if args.output or args.gnudump or args.plot:
        P.write_back(out, graph)
    if args.output:
        save_g2o(graph, args.output)
        print(f"Saving {args.output}", file=sys.stderr)
    if args.gnudump:
        from openslam_g2o_tpu.apps.viewer import write_gnuplot
        write_gnuplot(graph, args.gnudump)
        print(f"Gnuplot dump written to {args.gnudump}", file=sys.stderr)
    if args.plot:
        from openslam_g2o_tpu.apps.viewer import plot_graph
        plot_graph(graph, args.plot, title=args.input)
        print(f"Plot written to {args.plot}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
