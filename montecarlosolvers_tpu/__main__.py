"""Command-line interface: anneal instance files from the shell.

    python -m montecarlosolvers_tpu solve INSTANCE.txt --method piqmc \
        --num-reads 64 --sweeps 4000 [--negate] [--lattice L] [--out out.npz]

INSTANCE.txt is the reference's `i j J_ij` triplet format (1-indexed;
--negate applies the benchmark driver's coupling negation,
examples/santoro80.py:244). Prints the best energy and writes all samples
to --out when given.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# One choice per solve() method — kept in lockstep with
# solvers.api._METHOD_KW by tests/test_api.py; hardcoded here so parsing
# --help does not pay the jax import.
SOLVE_METHODS = ("sa", "sa_wolff", "sa_sw",
                 "piqmc", "piqmc_wolff", "piqmc_sw", "piqmc_sw_full",
                 "svmc", "pt", "icm", "pa", "paq")


def _build_problem(args):
    from montecarlosolvers_tpu.models import instances
    from montecarlosolvers_tpu.models.ising import IsingProblem
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    rows, cols, vals = instances.load_triplets(
        args.instance, negate=args.negate, one_indexed=not args.zero_indexed
    )
    if args.lattice:
        return LatticeProblem.from_edges(args.lattice, rows, cols, vals)
    n = int(max(rows.max(), cols.max())) + 1
    return IsingProblem.from_edges(n, rows, cols, vals)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="montecarlosolvers_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("solve", help="anneal an instance file")
    sp.add_argument("instance")
    sp.add_argument("--method", default="sa", choices=SOLVE_METHODS)
    sp.add_argument("--num-reads", type=int, default=64)
    sp.add_argument("--sweeps", type=int, default=1000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--slices", type=int, default=20,
                    help="Trotter slices (piqmc)")
    sp.add_argument("--negate", action="store_true",
                    help="negate couplings on load (benchmark convention)")
    sp.add_argument("--zero-indexed", action="store_true")
    sp.add_argument("--lattice", type=int, default=None, metavar="L",
                    help="treat as an L x L lattice (roll fast path)")
    sp.add_argument("--out", default=None, help="write samples to .npz")

    sub.add_parser("bench", help="run the throughput benchmark (GPU only)")

    args = ap.parse_args(argv)

    if args.cmd == "bench":
        # repo-root bench.py: resolve relative to the package so the
        # subcommand works from any cwd in a checkout
        import importlib.util
        import pathlib

        path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
        if not path.exists():
            print("bench.py not found (installed package without the "
                  "benchmark harness); run from a repo checkout",
                  file=sys.stderr)
            return 2
        spec = importlib.util.spec_from_file_location("mcs_bench", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main()

    from montecarlosolvers_tpu.solvers.api import solve
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()

    problem = _build_problem(args)
    kw = (dict(slices=args.slices)
          if args.method.startswith("piqmc") else {})
    res = solve(problem, method=args.method, num_reads=args.num_reads,
                sweeps=args.sweeps, seed=args.seed, **kw)
    print(json.dumps({
        "best_energy": res.best_energy,
        "mean_energy": float(res.energies.mean()),
        "num_reads": len(res),
        **{k: v for k, v in res.info.items() if k != "num_reads"},
    }))
    if args.out:
        np.savez(args.out, samples=res.samples, energies=res.energies)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
