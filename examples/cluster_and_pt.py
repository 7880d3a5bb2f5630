"""Cluster updates and parallel tempering — the beyond-reference solver
families, demonstrated on the certified 80x80 benchmark instance.

The reference (dtoconnor/MonteCarloSolvers) stops at local + line-global
moves for PIQMC and local-only classical SA; this framework adds

  * classical Wolff / Swendsen-Wang annealing (sa.anneal_wolff /
    sa.anneal_sw — the Gamma -> inf reduction of the space-time FK
    engine in ops/cluster.py),
  * full space-time Swendsen-Wang for PIQMC (qmc.anneal_sw: spatial,
    Trotter, and optionally bath bonds in ONE FK decomposition),
  * classical parallel tempering with measured ladder auto-tuning
    (pt.sample / pt.tune_ladder), and
  * quantum parallel tempering along the transverse-field ladder
    (pt.sample_piqmc / pt.tune_ladder_piqmc).

This demo runs each against a plain-SA baseline at small budgets and
prints residual energies. For where cluster updates actually pay (and
where they don't — they lose on this spin-glass instance at equal
wall-clock because FK clusters percolate), run
montecarlosolvers_tpu/bench/cluster_value.py and cluster_crossover.py.

Usage:
    python examples/cluster_and_pt.py [--tau 1000] [--chains 8]
        [--rungs 12] [--pt-sweeps 600]
"""

import argparse

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, qmc, pt
from montecarlosolvers_tpu import schedules


def eps_of(problem, e_gs, states):
    return float(
        (np.asarray(problem.energy(states)).mean() - e_gs) / problem.nspins
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tau", type=int, default=1000)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--rungs", type=int, default=48,
                    help="PT ladder size; adjacent-rung overlap needs the "
                         "rung ratio - 1 ~ 1/sqrt(N), so N=6400 wants "
                         "dozens of rungs (see pt.geometric_ladder)")
    ap.add_argument("--pt-sweeps", type=int, default=600)
    ap.add_argument("--slices", type=int, default=8,
                    help="Trotter slices for the quantum demos")
    args = ap.parse_args()

    problem, e_gs = instances.santoro_80x80()
    key = jax.random.key(7)
    k_sa, k_w, k_sw, k_qsw, k_tune, k_pt, k_qpt, k_icm = (
        jax.random.split(key, 8)
    )

    sched = schedules.linear(3.0, 0.0, args.tau)
    s0 = sa.random_state(key, problem.nspins, batch=(args.chains,))

    # --- classical: local vs local+Wolff vs SW at equal schedule --------
    s_loc = sa.anneal(problem, sched, s0, k_sa)
    print(f"SA local only        tau={args.tau}: "
          f"eps_res = {eps_of(problem, e_gs, s_loc):.4f}")

    s_w = sa.anneal_wolff(problem, sched, s0, k_w)  # local + 1 cluster/step
    print(f"SA + Wolff clusters  tau={args.tau}: "
          f"eps_res = {eps_of(problem, e_gs, s_w):.4f}")

    s_sw = sa.anneal_sw(problem, sched, s0, k_sw, local_sweeps=True)
    print(f"SA + Swendsen-Wang   tau={args.tau}: "
          f"eps_res = {eps_of(problem, e_gs, s_sw):.4f}")

    # --- quantum: full space-time SW on one chain -----------------------
    P = args.slices
    confs = qmc.replicate(s_loc[0], P)
    a = schedules.transverse_field(2.5, 1e-8, max(args.tau // 10, 20))
    out = qmc.anneal_sw(problem, a, jnp.ones_like(a), 1.0 / P, confs, k_qsw)
    e_best = float(qmc.best_slice_energy(problem, out[None]).mean())
    print(f"PIQMC space-time SW  P={P}: best-slice "
          f"eps_res = {(e_best - e_gs) / problem.nspins:.4f}")

    # --- classical PT: tuned ladder, equal-sweep SA baseline ------------
    temps0 = pt.geometric_ladder(0.3, 2.5, args.rungs)
    temps, pair_rates = pt.tune_ladder(problem, temps0, k_tune,
                                       rounds=3, sweeps_per_round=200)
    states = sa.random_state(k_pt, problem.nspins, batch=(args.rungs,))
    states, swap_rate = pt.sample(problem, temps, states, k_pt,
                                  args.pt_sweeps, swap_every=2)
    e_cold = float(np.asarray(problem.energy(states)).min())
    print(f"PT {args.rungs} rungs, {args.pt_sweeps} sweeps: swap rate "
          f"{float(swap_rate):.2f} (tuned pair rates "
          f"{np.min(pair_rates):.2f}..{np.max(pair_rates):.2f}), coldest "
          f"eps_res = {(e_cold - e_gs) / problem.nspins:.4f}")

    # --- ICM: PT + Houdayer overlap-domain cluster moves -----------------
    pair0 = sa.random_state(k_icm, problem.nspins, batch=(2, args.rungs))
    pair, icm_rate, hfrac = pt.sample_icm(
        problem, temps, pair0, k_icm, args.pt_sweeps // 2,
        swap_every=2, houdayer_every=2,
    )
    e_icm = float(np.asarray(problem.energy(pair)).min())
    print(f"ICM (2 ladders + Houdayer): swap rate {float(icm_rate):.2f}, "
          f"flip frac {float(hfrac):.2f}, coldest "
          f"eps_res = {(e_icm - e_gs) / problem.nspins:.4f}")

    # --- quantum PT along the Gamma ladder at fixed T --------------------
    gammas = jnp.linspace(1.5, 0.3, args.rungs)
    qconfs = jnp.broadcast_to(
        qmc.replicate(s_loc[: 1], P), (args.rungs, P, problem.nspins)
    )
    qconfs, qswap = pt.sample_piqmc(
        problem, gammas, 1.0 / P, qconfs, k_qpt,
        args.pt_sweeps // 4, global_moves=True,
    )
    e_q = float(qmc.best_slice_energy(problem, qconfs).min())
    print(f"Quantum PT (Gamma ladder): swap rate {float(qswap):.2f}, "
          f"best-slice eps_res = {(e_q - e_gs) / problem.nspins:.4f}")

    # --- population annealing: weighted ensemble + free energy -----------
    from montecarlosolvers_tpu.solvers import pa

    pop = sa.random_state(jax.random.fold_in(key, 9), problem.nspins,
                          batch=(max(256, args.chains),))
    temps_pa = pa.beta_linear(3.0, args.tau, beta_start=0.0)
    pop, log_z, stats = pa.sample(problem, temps_pa, pop,
                                  jax.random.fold_in(key, 10),
                                  beta0=0.0, collect_stats=True)
    f_per_spin = (float(log_z) + pa.uniform_log_z(problem.nspins)) \
        / problem.nspins
    print(f"PA {pop.shape[0]} replicas, {args.tau} beta steps: "
          f"eps_res = {eps_of(problem, e_gs, pop):.4f}, "
          f"ln Z / N = {f_per_spin:.4f} (free energy, PA-exclusive), "
          f"min ESS {float(np.asarray(stats['ess']).min()) / pop.shape[0]:.2f}")


if __name__ == "__main__":
    main()
