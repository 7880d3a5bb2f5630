"""Parallel-tempering value experiment (round 4).

Parallel tempering is the framework's headline beyond-reference solver
family (the reference has no replica-exchange component; SURVEY.md §2.3
lists its complete parallelism inventory). Following the cluster_value
precedent (VERDICT r3 #2: "the capability exists; its value is
undemonstrated"), this experiment measures whether PT actually earns its
rungs on the certified santoro 80x80 instance, on the accelerator, at
equal budget.

Two claims are tested, matching PT's two textbook use cases:

1. SAMPLING: equilibrium at a low temperature. M quenched chains run
   local colored-Metropolis at T_cold for S sweeps; the PT arm spends the
   *same M x S sweep budget* across a tuned ladder whose coldest rung is
   T_cold. Metric: mean energy of the T_cold ensemble over the second
   half of the run (lower = closer to equilibrium; quenched local
   dynamics at low T is trapped above it). Wall-clock is recorded — the
   swap phases are the only extra cost and they are two energy
   reductions per exchange cadence.

2. OPTIMIZATION at equal wall-clock: best residual energy found. PT
   (M rungs x S sweeps, final states, min over rungs) vs SA restarts
   (M chains, linear 3->0 schedule) re-run at tau' chosen so the SA
   arm's measured wall matches PT's — the same honest equal-wall
   methodology as cluster_value.py. A quantum variant races
   transverse-field-ladder PT (pt.sample_piqmc) against a plain PIQMC
   local+global anneal at equal wall.

Writes results/pt_value/summary.json (resume-cached by arm name) and
prints each arm as it lands.
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, qmc, pt
from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.bench._common import make_recorder, timed


RUNGS = 48
SWEEPS = 2000
T_COLD = 0.5
T_HOT = 2.5
# quantum-PT arm sizes: adjacent-rung K-overlap needs dense rungs at
# N=6400 (measured: 16 rungs over Gamma 2.5->0.05 gave swap rate 0.001 —
# no exchange; 48 rungs over 1.5->0.3 gives ~0.3)
Q_RUNGS, Q_SLICES, Q_SWEEPS = 48, 20, 500
Q_GAMMA_HI, Q_GAMMA_LO = 1.5, 0.3



def sampling_arms(problem, e_gs, key, done, record):
    """PT vs quenched local dynamics at T_cold, equal sweep budget."""
    k_init, k_tune, k_pt, k_q = jax.random.split(key, 4)
    s0 = sa.random_state(k_init, problem.nspins, batch=(RUNGS,))

    temps0 = pt.geometric_ladder(T_COLD, T_HOT, RUNGS)
    temps, pair_rates = pt.tune_ladder(
        problem, temps0, k_tune, rounds=3, sweeps_per_round=200
    )

    def pt_run(seed):
        states, rate, es = pt.sample(
            problem, temps, s0, jax.random.fold_in(k_pt, seed),
            SWEEPS, swap_every=2, collect_energy=True,
        )
        return states, rate, es

    def arm_pt():
        (states, rate, es), wall = timed(lambda seed: pt_run(seed))
        es = np.asarray(es)  # (SWEEPS, M); rung 0 is T_cold (ascending)
        e_cold = float(es[SWEEPS // 2:, 0].mean())
        return dict(
            eps_cold=float((e_cold - e_gs) / problem.nspins),
            swap_rate=float(rate),
            pair_rate_min=float(np.min(pair_rates)),
            wall_s=wall,
            total_sweeps=RUNGS * SWEEPS,
        )

    def arm_quench():
        sched = jnp.full((SWEEPS,), T_COLD, jnp.float32)

        def run(seed):
            return sa.anneal(
                problem, sched, s0, jax.random.fold_in(k_q, seed),
                collect_energy=True,
            )

        (_, es), wall = timed(lambda seed: run(seed))
        es = np.asarray(es)  # (SWEEPS, M)
        e_cold = float(es[SWEEPS // 2:].mean())
        return dict(
            eps_cold=float((e_cold - e_gs) / problem.nspins),
            wall_s=wall,
            total_sweeps=RUNGS * SWEEPS,
        )

    p = record("sampling_pt", arm_pt)
    q = record("sampling_quench", arm_quench)
    if p and q:
        # equal-wall quench: the PT arm pays for its swap phases (two
        # energy reductions per cadence); give the quench the same wall
        sweeps_eq = int(SWEEPS * p["wall_s"] / max(q["wall_s"], 1e-9))

        def arm_quench_eq():
            sched = jnp.full((sweeps_eq,), T_COLD, jnp.float32)

            def run(seed):
                return sa.anneal(
                    problem, sched, s0, jax.random.fold_in(k_q, 100 + seed),
                    collect_energy=True,
                )

            (_, es), wall = timed(lambda seed: run(seed))
            es = np.asarray(es)
            e_cold = float(es[sweeps_eq // 2:].mean())
            return dict(
                eps_cold=float((e_cold - e_gs) / problem.nspins),
                wall_s=wall,
                total_sweeps=RUNGS * sweeps_eq,
            )

        record(f"sampling_quench_equalwall_s{sweeps_eq}", arm_quench_eq)


def icm_arms(problem, e_gs, key, done, record):
    """Isoenergetic cluster moves (Houdayer + PT, pt.sample_icm) vs plain
    PT at the same total sweep budget: ICM runs 2 ladders x RUNGS rungs x
    SWEEPS/2 sweeps = the PT arms' RUNGS x SWEEPS sweeps, plus one
    Houdayer phase per 2 sweeps. The literature claim (Zhu-Ochoa-
    Katzgraber 2015) is that the overlap-domain cluster flips tunnel
    between the valleys that trap both quenched dynamics AND plain PT on
    spin glasses."""
    S = SWEEPS // 2
    k_init, k_tune, k_s, k_o = jax.random.split(key, 4)
    s0 = sa.random_state(k_init, problem.nspins, batch=(2, RUNGS))

    temps0 = pt.geometric_ladder(T_COLD, T_HOT, RUNGS)
    temps, _ = pt.tune_ladder(
        problem, temps0, k_tune, rounds=3, sweeps_per_round=200
    )

    def arm_sampling():
        def run(seed):
            return pt.sample_icm(
                problem, temps, s0, jax.random.fold_in(k_s, seed), S,
                swap_every=2, houdayer_every=2, collect_energy=True,
            )

        (_, rate, hfrac, es), wall = timed(lambda seed: run(seed))
        es = np.asarray(es)  # (S, 2, M); rung 0 is T_cold
        e_cold = float(es[S // 2:, :, 0].mean())
        return dict(
            eps_cold=float((e_cold - e_gs) / problem.nspins),
            swap_rate=float(rate),
            houdayer_flip_frac=float(hfrac),
            wall_s=wall,
            total_sweeps=2 * RUNGS * S,
        )

    temps_o0 = pt.geometric_ladder(0.3, T_HOT, RUNGS)
    temps_o, _ = pt.tune_ladder(
        problem, temps_o0, jax.random.fold_in(k_tune, 1), rounds=3,
        sweeps_per_round=200,
    )

    def arm_opt():
        def run(seed):
            return pt.sample_icm(
                problem, temps_o, s0, jax.random.fold_in(k_o, seed), S,
                swap_every=2, houdayer_every=2,
            )

        (states, rate, hfrac), wall = timed(lambda seed: run(seed))
        e_min = float(np.asarray(problem.energy(states)).min())
        return dict(
            eps_best=float((e_min - e_gs) / problem.nspins),
            swap_rate=float(rate),
            houdayer_flip_frac=float(hfrac),
            wall_s=wall,
        )

    record("sampling_icm", arm_sampling)
    record("opt_icm", arm_opt)


def optimization_arms(problem, e_gs, key, done, record):
    """Best energy found: PT vs SA restarts at equal wall-clock."""
    k_init, k_tune, k_pt, k_sa = jax.random.split(key, 4)
    s0 = sa.random_state(k_init, problem.nspins, batch=(RUNGS,))

    temps0 = pt.geometric_ladder(0.3, T_HOT, RUNGS)
    temps, _ = pt.tune_ladder(
        problem, temps0, k_tune, rounds=3, sweeps_per_round=200
    )

    def arm_pt():
        def run(seed):
            states, rate = pt.sample(
                problem, temps, s0, jax.random.fold_in(k_pt, seed),
                SWEEPS, swap_every=2,
            )
            return states, rate

        (states, rate), wall = timed(lambda seed: run(seed))
        e_min = float(np.asarray(problem.energy(states)).min())
        return dict(
            eps_best=float((e_min - e_gs) / problem.nspins),
            swap_rate=float(rate),
            wall_s=wall,
        )

    def sa_arm(tau):
        sched = schedules.linear(3.0, 0.0, tau)

        def run(seed):
            return sa.anneal(
                problem, sched, s0, jax.random.fold_in(k_sa, seed)
            )

        states, wall = timed(lambda seed: run(seed))
        e_min = float(np.asarray(problem.energy(states)).min())
        return dict(
            eps_best=float((e_min - e_gs) / problem.nspins),
            wall_s=wall,
            tau=int(tau),
        )

    p = record("opt_pt", arm_pt)
    b = record(f"opt_sa_tau{SWEEPS}", lambda: sa_arm(SWEEPS))
    if p and b:
        tau_eq = int(SWEEPS * p["wall_s"] / max(b["wall_s"], 1e-9))
        record(f"opt_sa_equalwall_tau{tau_eq}", lambda: sa_arm(tau_eq))


def quantum_arms(problem, e_gs, key, done, record):
    """Gamma-ladder PT vs plain PIQMC local+global anneal, equal wall."""
    M, P, S = Q_RUNGS, Q_SLICES, Q_SWEEPS
    pt_temp = 1.0 / P  # PT=1 benchmark convention: T = PT/P
    k_init, k_tune, k_pt, k_q = jax.random.split(key, 4)
    s0 = sa.random_state(k_init, problem.nspins, batch=(M,))
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, 1.0), s0,
                   k_init, mcsteps=100)
    confs0 = jax.vmap(lambda s: qmc.replicate(s, P))(s0)  # (M, P, N)

    gammas0 = jnp.geomspace(Q_GAMMA_HI, Q_GAMMA_LO, M)
    gammas, _ = pt.tune_ladder_piqmc(
        problem, gammas0, pt_temp, k_tune, rounds=2, sweeps_per_round=100,
        global_moves=True, confs=confs0,
    )

    # PT rungs live at Gamma >= Q_GAMMA_LO while the anneal baseline ends
    # near Gamma = 0; quench the PT output classical (inside its timed
    # wall) so both arms are read out in the same limit
    a_qnch = jnp.asarray(
        np.geomspace(Q_GAMMA_LO, 1e-8, 100, dtype=np.float32)
    )

    def arm_qpt():
        def run(seed):
            confs, rate = pt.sample_piqmc(
                problem, gammas, pt_temp, confs0,
                jax.random.fold_in(k_pt, seed), S,
                swap_every=2, global_moves=True,
            )
            confs = qmc.anneal(
                problem, a_qnch, jnp.ones_like(a_qnch), pt_temp, confs,
                jax.random.fold_in(k_pt, 500 + seed), global_moves=True,
            )
            return confs, rate

        (confs, rate), wall = timed(lambda seed: run(seed))
        e_min = float(np.asarray(qmc.best_slice_energy(problem, confs)).min())
        return dict(
            eps_best=float((e_min - e_gs) / problem.nspins),
            swap_rate=float(rate),
            wall_s=wall,
        )

    def piqmc_arm(tau):
        a = jnp.asarray(np.linspace(2.5, 1e-8, int(tau), dtype=np.float32))

        def run(seed):
            return qmc.anneal(
                problem, a, jnp.ones_like(a), pt_temp, confs0,
                jax.random.fold_in(k_q, seed), global_moves=True,
            )

        confs, wall = timed(lambda seed: run(seed))
        e_min = float(np.asarray(qmc.best_slice_energy(problem, confs)).min())
        return dict(
            eps_best=float((e_min - e_gs) / problem.nspins),
            wall_s=wall,
            tau=int(tau),
        )

    p = record("quantum_pt", arm_qpt)
    b = record(f"quantum_piqmc_tau{S}", lambda: piqmc_arm(S))
    if p and b:
        tau_eq = int(S * p["wall_s"] / max(b["wall_s"], 1e-9))
        record(f"quantum_piqmc_equalwall_tau{tau_eq}",
               lambda: piqmc_arm(tau_eq))


def main(outdir="results/pt_value", budget_s=1500):
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)

    problem, e_gs = instances.santoro_80x80(lattice=True)
    key = jax.random.key(11)
    record = make_recorder(path, done, budget_s=budget_s)

    k1, k2, k3, k4 = jax.random.split(key, 4)
    sampling_arms(problem, e_gs, k1, done, record)
    optimization_arms(problem, e_gs, k2, done, record)
    quantum_arms(problem, e_gs, k3, done, record)
    icm_arms(problem, e_gs, k4, done, record)
    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
