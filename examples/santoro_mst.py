"""Reproduce the Martonak–Santoro–Tosatti SA-vs-PIQMC benchmark on a GPU.

The JAX analog of the reference's examples/santoro80.py driver:
loads the certified 80x80 instance, sweeps tau for classical annealing and
PIQMC at P in {5,10,20,40}, checkpoints incrementally, and writes the
log-log residual-energy plot.

Usage:
    python examples/santoro_mst.py [--max-tau 60000] [--reps 45]

Long matrices can run as a restart loop under a wall-clock budget;
exit code 3 means "budget spent, more work remains":

    until python examples/santoro_mst.py --budget 900; do
        [ $? -ne 3 ] && break
    done
"""

import argparse
import sys

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.bench import mst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-tau", type=int, default=None,
                    help="cap the tau sweep (full sweep reaches 6e6)")
    ap.add_argument("--reps", type=int, default=45)
    ap.add_argument("--outdir", default="mst_results")
    ap.add_argument("--budget", type=float, default=None,
                    help="wall-clock budget in seconds; exit(3) if more "
                         "work remains (resume by re-running)")
    args = ap.parse_args()

    problem, e_gs = instances.santoro_80x80(lattice=True)
    results, complete = mst.mst_benchmark(
        problem, e_gs, outdir=args.outdir, reps=args.reps,
        max_tau=args.max_tau, budget_s=args.budget,
    )
    if not complete:
        print("budget spent; re-run to resume")
        sys.exit(3)
    results = mst.summarize_dir(args.outdir, problem.nspins, e_gs)
    # equal-work axis (tau * P) and the reference/MST-2002 convention
    # (equal tau; PIQMC gets P x more flip attempts at equal x)
    mst.plot_results(results, path=f"{args.outdir}/santoro_mst.png")
    mst.plot_results(results, path=f"{args.outdir}/santoro_mst_ref.png",
                     x="tau")
    print(f"wrote {args.outdir}/santoro_mst.png (+_ref.png)")


if __name__ == "__main__":
    main()
