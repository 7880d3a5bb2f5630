"""Open-system (dissipative) quantum annealing demo.

Runs the system-bath PIQMC extensions on the certified 80x80 instance
and prints how residual energy responds to the bath coupling alpha —
the physics question the reference's dissipative kernels exist to ask
(qmc.pyx:149-278 DissipativeQuantumAnneal, qmc.pyx:444-609 ...Global;
the bath Hamiltonian alpha*(pi/(P sin(pi d/P)))^2 is documented at
qmc.pyx:162-163). On even-L lattices the solver dispatches to the
split-checkerboard bath engine (ops/split.qmc_bath_anneal_split).

Usage:
    python examples/dissipative_qa.py [--tau 2000] [--slices 20]
        [--chains 16] [--alphas 0 0.01 0.05]

Each alpha runs the full MST protocol (classical pre-anneal, replicate,
Gamma anneal with whole-line global moves) with the bath term added.
"""

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, qmc
from montecarlosolvers_tpu import schedules


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tau", type=int, default=2000)
    ap.add_argument("--slices", type=int, default=20)
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--pt", type=float, default=1.0,
                    help="effective temperature P*T (qmc.pyx:85)")
    ap.add_argument("--alphas", type=float, nargs="+",
                    default=[0.0, 0.01, 0.05])
    args = ap.parse_args()

    problem, e_gs = instances.santoro_80x80(lattice=True)
    P = args.slices
    temp = args.pt / P
    key = jax.random.key(0)
    k1, k2, k3 = jax.random.split(key, 3)

    # MST protocol: classical pre-anneal to PT, then replicate
    # (examples/santoro80.py:284-286)
    s0 = sa.random_state(k1, problem.nspins, batch=(args.chains,))
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, args.pt),
                   s0, k2, mcsteps=5)
    confs0 = qmc.replicate(s0, P)
    a = schedules.transverse_field(3.0, 1e-8, args.tau)
    b = jnp.ones_like(a)

    print(f"santoro 80x80, P={P}, tau={args.tau}, chains={args.chains}, "
          f"PT={args.pt}")
    for alpha in args.alphas:
        lut = (schedules.bath_lookuptable(P, alpha) if alpha > 0.0
               else None)
        t0 = time.time()
        confs = qmc.anneal(problem, a, b, temp, confs0, k3,
                           global_moves=True, lookuptable=lut)
        es = np.asarray(qmc.best_slice_energy(problem, confs))
        eps = (es.mean() - e_gs) / problem.nspins
        print(f"  alpha={alpha:<6g} eps_res={eps:.5f} "
              f"(best chain {((es.min() - e_gs) / problem.nspins):.5f}, "
              f"{time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
