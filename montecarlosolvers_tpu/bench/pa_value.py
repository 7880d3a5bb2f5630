"""Population-annealing value experiment (round 4).

Following the cluster_value / pt_value precedent ("the capability
exists; its value is undemonstrated"), this measures whether PA's
resampling earns its cost on the certified santoro 80x80 instance, on
the accelerator, at equal budget — against the same baselines pt_value used, at the
same cold temperature, so all three studies cross-compare.

1. SAMPLING at T_cold = 0.5 (pt_value's target): R quenched chains run
   local dynamics at T_cold for S sweeps (the trapped baseline);
   the PA arm spends S beta-linear steps from beta=0 to 1/T_cold with
   one sweep per step and per-step resampling. Metric: mean energy of
   the T_cold ensemble (PA: final population; quench: second-half
   trace). PA's per-step overhead — an (R,) energy readout, logsumexp,
   cumsum, one row gather — is timed honestly and the quench gets an
   equal-wall rematch. PA also reports the absolute free energy
   ln Z(beta)/N, which no other sampler in the repo can estimate.

2. OPTIMIZATION at equal wall-clock: best residual energy found. PA
   (beta 0 -> 1/T_OPT over S steps, min over the final population) vs
   SA restarts (R chains, linear 3 -> 0) re-run at tau' matching PA's
   measured wall — the same methodology as cluster_value/pt_value.

Writes results/pa_value/summary.json (resume-cached by arm name).
"""

from __future__ import annotations

import json
import os

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, pa
from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.bench._common import make_recorder, timed


REPLICAS = 1024
SWEEPS = 4000
T_COLD = 0.5   # pt_value's sampling target: eps cross-comparable
T_OPT = 0.1    # optimization arm's final temperature (beta_end = 10)
MCSTEPS = 1



def sampling_arms(problem, e_gs, key, done, record):
    """PA vs quenched local dynamics at T_cold, equal step budget then
    equal wall."""
    k_init, k_pa, k_q = jax.random.split(key, 3)
    n = problem.nspins
    s0 = sa.random_state(k_init, n, batch=(REPLICAS,))

    temps_pa = pa.beta_linear(1.0 / T_COLD, SWEEPS, beta_start=0.0)

    def arm_pa():
        def run(seed):
            return pa.sample(
                problem, temps_pa, s0, jax.random.fold_in(k_pa, seed),
                mcsteps=MCSTEPS, beta0=0.0, collect_stats=True,
            )

        (states, log_z, stats), wall = timed(lambda seed: run(seed))
        es = np.asarray(problem.energy(states))
        return dict(
            eps_cold=float((es.mean() - e_gs) / n),
            log_z_per_spin=float(log_z) / n + float(np.log(2.0)),
            min_ess_frac=float(np.asarray(stats["ess"]).min()) / REPLICAS,
            wall_s=wall,
            total_sweeps=REPLICAS * SWEEPS * MCSTEPS,
        )

    def quench_arm(sweeps, tag_seed):
        sched = jnp.full((sweeps,), T_COLD, jnp.float32)

        def run(seed):
            return sa.anneal(
                problem, sched, s0, jax.random.fold_in(k_q, tag_seed + seed),
                collect_energy=True,
            )

        (_, es), wall = timed(lambda seed: run(seed))
        es = np.asarray(es)  # (sweeps, R)
        e_cold = float(es[sweeps // 2:].mean())
        return dict(
            eps_cold=float((e_cold - e_gs) / n),
            wall_s=wall,
            total_sweeps=REPLICAS * sweeps,
        )

    p = record("sampling_pa", arm_pa)
    q = record("sampling_quench", lambda: quench_arm(SWEEPS, 0))
    if p and q:
        # equal-wall quench rematch: PA pays for its per-step energy
        # readout + resample; give the quench the same measured wall
        sweeps_eq = int(SWEEPS * p["wall_s"] / max(q["wall_s"], 1e-9))
        record(f"sampling_quench_equalwall_s{sweeps_eq}",
               lambda: quench_arm(sweeps_eq, 100))

    # matched-resource PT: pt_value's sampling_pt ran ONE 48-rung ladder
    # (48 replicas); here PT gets PA's replica count AND sweep count —
    # ceil(R/RUNGS) independent tuned ladders vmapped side by side, the
    # strongest PT configuration this hardware budget buys
    from montecarlosolvers_tpu.solvers import pt

    rungs = 48
    ladders = max(1, REPLICAS // rungs)
    k_tune, k_run = jax.random.split(jax.random.fold_in(key, 77))

    def arm_pt_matched():
        temps0 = pt.geometric_ladder(T_COLD, 2.5, rungs)
        temps, _ = pt.tune_ladder(problem, temps0, k_tune, rounds=3,
                                  sweeps_per_round=200)
        states = sa.random_state(k_run, n, batch=(ladders, rungs))
        keys = jax.random.split(k_run, ladders)

        def run(seed):
            return jax.vmap(
                lambda s, k: pt.sample(
                    problem, temps, s, jax.random.fold_in(k, seed),
                    SWEEPS, swap_every=2, collect_energy=True,
                )
            )(states, keys)

        (_, rates, es), wall = timed(lambda seed: run(seed))
        es = np.asarray(es)  # (ladders, SWEEPS, rungs); rung 0 = T_cold
        e_cold = float(es[:, SWEEPS // 2:, 0].mean())
        return dict(
            eps_cold=float((e_cold - e_gs) / n),
            swap_rate=float(np.asarray(rates).mean()),
            wall_s=wall,
            total_sweeps=ladders * rungs * SWEEPS,
            replicas=ladders * rungs,
        )

    record(f"sampling_pt_matched_{ladders}x{rungs}", arm_pt_matched)


def optimization_arms(problem, e_gs, key, done, record):
    """Best energy found: PA vs SA restarts at equal wall-clock."""
    k_init, k_pa, k_sa = jax.random.split(key, 3)
    n = problem.nspins
    s0 = sa.random_state(k_init, n, batch=(REPLICAS,))

    temps_pa = pa.beta_linear(1.0 / T_OPT, SWEEPS, beta_start=0.0)

    def arm_pa():
        def run(seed):
            return pa.sample(
                problem, temps_pa, s0, jax.random.fold_in(k_pa, seed),
                mcsteps=MCSTEPS, beta0=0.0, collect_stats=True,
            )

        (states, log_z, stats), wall = timed(lambda seed: run(seed))
        es = np.asarray(problem.energy(states))
        return dict(
            eps_best=float((es.min() - e_gs) / n),
            eps_mean=float((es.mean() - e_gs) / n),
            min_ess_frac=float(np.asarray(stats["ess"]).min()) / REPLICAS,
            wall_s=wall,
        )

    def sa_arm(tau, tag_seed):
        sched = schedules.linear(3.0, 0.0, tau)

        def run(seed):
            return sa.anneal(
                problem, sched, s0, jax.random.fold_in(k_sa, tag_seed + seed)
            )

        states, wall = timed(lambda seed: run(seed))
        es = np.asarray(problem.energy(states))
        return dict(
            eps_best=float((es.min() - e_gs) / n),
            eps_mean=float((es.mean() - e_gs) / n),
            wall_s=wall,
            tau=int(tau),
        )

    p = record("opt_pa", arm_pa)
    b = record(f"opt_sa_tau{SWEEPS}", lambda: sa_arm(SWEEPS, 0))
    if p and b:
        tau_eq = int(SWEEPS * p["wall_s"] / max(b["wall_s"], 1e-9))
        record(f"opt_sa_equalwall_tau{tau_eq}", lambda: sa_arm(tau_eq, 100))

    # matched-resource PT for optimization (ladder reaching T_OPT)
    from montecarlosolvers_tpu.solvers import pt

    rungs = 48
    ladders = max(1, REPLICAS // rungs)
    k_tune, k_run = jax.random.split(jax.random.fold_in(key, 78))

    def arm_pt_matched():
        temps0 = pt.geometric_ladder(T_OPT, 2.5, rungs)
        temps, _ = pt.tune_ladder(problem, temps0, k_tune, rounds=3,
                                  sweeps_per_round=200)
        states = sa.random_state(k_run, n, batch=(ladders, rungs))
        keys = jax.random.split(k_run, ladders)

        def run(seed):
            return jax.vmap(
                lambda s, k: pt.sample(
                    problem, temps, s, jax.random.fold_in(k, seed),
                    SWEEPS, swap_every=2,
                )
            )(states, keys)

        (states_out, rates), wall = timed(lambda seed: run(seed))
        es = np.asarray(problem.energy(states_out.reshape(-1, n)))
        return dict(
            eps_best=float((es.min() - e_gs) / n),
            eps_mean=float((es.mean() - e_gs) / n),
            swap_rate=float(np.asarray(rates).mean()),
            wall_s=wall,
            replicas=ladders * rungs,
        )

    record(f"opt_pt_matched_{ladders}x{rungs}", arm_pt_matched)


def v2_arms(problem, e_gs, key, done, record):
    """Round-5 arms (VERDICT r4 missing #2): adaptive-step PA, weighted
    multi-run combining, and PA over the PIQMC extended ensemble."""
    n = problem.nspins
    k_init, k_ad, k_comb, k_q = jax.random.split(key, 4)
    s0 = sa.random_state(k_init, n, batch=(REPLICAS,))

    # --- adaptive dbeta (ESS-targeted) vs the fixed beta-linear grid ----
    def arm_adaptive(beta_end, tag):
        def run():
            return pa.sample_adaptive(
                problem, beta_end, s0, k_ad, target_frac=0.9,
                mcsteps=MCSTEPS, max_steps=2 * SWEEPS,
            )

        # adaptive runs are not seed-replayable through `timed`'s best-of-2
        # (same key reuses the same schedule); time two identical calls
        import time as _t

        states, log_z, stats = run()
        jax.block_until_ready(states)
        t0 = _t.time()
        states, log_z, stats = run()
        jax.block_until_ready(states)
        wall = _t.time() - t0
        es = np.asarray(problem.energy(states))
        return dict(
            eps_cold=float((es.mean() - e_gs) / n),
            eps_best=float((es.min() - e_gs) / n),
            log_z_per_spin=float(log_z) / n + float(np.log(2.0)),
            n_steps=stats["n_steps"],
            reached=stats["reached"],
            families=stats["families"],
            min_ess_frac=float(stats["ess"].min()) / REPLICAS,
            wall_s=round(wall, 3),
        )

    a_cold = record("sampling_pa_adaptive", lambda: arm_adaptive(
        1.0 / T_COLD, "cold"))
    a_opt = record("opt_pa_adaptive", lambda: arm_adaptive(
        1.0 / T_OPT, "opt"))

    # The arms above run mcsteps=1 per adaptive step, so their TOTAL
    # sweep budget is n_steps (~350-400) — an order below the fixed
    # grid's SWEEPS. The fair comparison scales mcsteps so total sweeps
    # match: the adaptive grid decides WHERE to resample, not how little
    # to sweep.
    def arm_adaptive_eq(beta_end, n_steps, tag):
        m = max(1, SWEEPS // max(n_steps, 1))

        def run():
            return pa.sample_adaptive(
                problem, beta_end, s0, jax.random.fold_in(k_ad, 1),
                target_frac=0.9, mcsteps=m, max_steps=2 * SWEEPS,
            )

        import time as _t

        states, log_z, stats = run()
        jax.block_until_ready(states)
        t0 = _t.time()
        states, log_z, stats = run()
        jax.block_until_ready(states)
        wall = _t.time() - t0
        es = np.asarray(problem.energy(states))
        return dict(
            eps_cold=float((es.mean() - e_gs) / n),
            eps_best=float((es.min() - e_gs) / n),
            log_z_per_spin=float(log_z) / n + float(np.log(2.0)),
            n_steps=stats["n_steps"],
            mcsteps=m,
            total_sweeps=REPLICAS * stats["n_steps"] * m,
            families=stats["families"],
            wall_s=round(wall, 3),
        )

    if a_cold:
        record("sampling_pa_adaptive_eqsweeps",
               lambda: arm_adaptive_eq(1.0 / T_COLD, a_cold["n_steps"],
                                       "cold"))
    ae = None
    if a_opt:
        ae = record("opt_pa_adaptive_eqsweeps",
                    lambda: arm_adaptive_eq(1.0 / T_OPT, a_opt["n_steps"],
                                            "opt"))

    # SA restarts rematched to the adaptive arm's measured wall — the
    # equal-WALL bar the round-4 study set (its SA tau6729 matched the
    # fixed-grid PA arm; the adaptive arm's wall differs)
    if ae:
        def arm_sa_eq():
            base = done.get(f"opt_sa_tau{SWEEPS}")
            w_per_tau = (base["wall_s"] / base["tau"]) if base else None
            tau = (int(ae["wall_s"] / w_per_tau) if w_per_tau
                   else 3 * SWEEPS)

            def run(seed):
                return sa.anneal(
                    problem, schedules.linear(3.0, 0.0, tau), s0,
                    jax.random.fold_in(k_ad, 200 + seed)
                )

            states, wall = timed(lambda seed: run(seed))
            es = np.asarray(problem.energy(states))
            return dict(
                eps_best=float((es.min() - e_gs) / n),
                eps_mean=float((es.mean() - e_gs) / n),
                wall_s=wall, tau=int(tau),
            )

        record("opt_sa_equalwall_for_adaptive", arm_sa_eq)

    # --- weighted combining of K independent runs -----------------------
    def arm_combined(K=8):
        temps_pa = pa.beta_linear(1.0 / T_COLD, SWEEPS, beta_start=0.0)
        lzs, fams, means = [], [], []
        for k in range(K):
            sk = sa.random_state(jax.random.fold_in(k_comb, k), n,
                                 batch=(REPLICAS,))
            states, lz, stats = pa.sample(
                problem, temps_pa, sk, jax.random.fold_in(k_comb, 100 + k),
                mcsteps=MCSTEPS, beta0=0.0, collect_stats=True,
            )
            es = np.asarray(problem.energy(states))
            lzs.append(float(lz))
            fams.append(stats["families"])
            means.append(float(es.mean()))
        comb = pa.combine_runs(lzs, observables=means)
        return dict(
            runs=K,
            eps_cold_combined=float((comb["observable"] - e_gs) / n),
            eps_cold_per_run=[round((m - e_gs) / n, 6) for m in means],
            log_z_per_spin=comb["log_z"] / n + float(np.log(2.0)),
            run_ess=round(comb["run_ess"], 2),
            families_per_run=fams,
            families_combined=int(np.sum(fams)),
        )

    record("sampling_pa_combined_k8", arm_combined)

    # --- PA x PIQMC: resampling over the extended ensemble --------------
    from montecarlosolvers_tpu.solvers import qmc

    R_Q, P_Q, S_Q = 256, 20, 1000
    pt_temp = 1.0 / P_Q  # PT=1 benchmark convention

    def arm_paq():
        confs = jnp.where(
            jax.random.bernoulli(k_q, 0.5, (R_Q, P_Q, n)), 1.0, -1.0
        )
        gammas = schedules.transverse_field(2.5, 1e-8, S_Q)

        def run(seed):
            return pa.sample_piqmc(
                problem, gammas, pt_temp, confs,
                jax.random.fold_in(k_q, seed), mcsteps=MCSTEPS,
                global_moves=True, collect_stats=True,
            )

        (out, log_z, stats), wall = timed(lambda seed: run(seed))
        es = np.asarray(qmc.best_slice_energy(problem, out))
        return dict(
            eps_best=float((es.min() - e_gs) / n),
            eps_mean=float((es.mean() - e_gs) / n),
            families=stats["families"],
            min_ess_frac=float(np.asarray(stats["ess"]).min()) / R_Q,
            resample_frac=float(np.asarray(stats["resampled"]).mean()),
            wall_s=wall,
            replicas=R_Q, slices=P_Q, steps=S_Q,
        )

    p = record("opt_paq", arm_paq)

    # Fixed-grid quantum PA collapses (measured: min ESS 0.4%, resample
    # every step, 1 family) — the kinetic-term spread makes uniform
    # Gamma steps wildly non-uniform in ensemble distance. The adaptive
    # Gamma grid (sample_piqmc_adaptive) is the principled schedule; its
    # step count measures how expensive exact extended-ensemble tracking
    # IS at benchmark scale.
    def arm_paq_adaptive():
        confs = jnp.where(
            jax.random.bernoulli(k_q, 0.5, (R_Q, P_Q, n)), 1.0, -1.0
        )

        def run():
            return pa.sample_piqmc_adaptive(
                problem, 2.5, 1e-3, pt_temp, confs,
                jax.random.fold_in(k_q, 9), target_frac=0.8,
                mcsteps=1, max_steps=4096, global_moves=True,
            )

        import time as _t

        out, log_z, stats = run()
        jax.block_until_ready(out)
        t0 = _t.time()
        out, log_z, stats = run()
        jax.block_until_ready(out)
        wall = _t.time() - t0
        es = np.asarray(qmc.best_slice_energy(problem, out))
        return dict(
            eps_best=float((es.min() - e_gs) / n),
            eps_mean=float((es.mean() - e_gs) / n),
            n_steps=stats["n_steps"],
            reached=stats["reached"],
            families=stats["families"],
            min_ess_frac=float(stats["ess"].min()) / R_Q
            if stats["n_steps"] else None,
            wall_s=round(wall, 3),
            replicas=R_Q, slices=P_Q,
        )

    pa_ad = record("opt_paq_adaptive", arm_paq_adaptive)

    # equal-wall plain PIQMC rematches (same population, no resampling)
    def arm_piqmc_eq(target_wall):
        confs = jnp.where(
            jax.random.bernoulli(k_q, 0.5, (R_Q, P_Q, n)), 1.0, -1.0
        )

        def run(tau, seed):
            a = schedules.transverse_field(2.5, 1e-8, tau)
            return qmc.anneal(
                problem, a, jnp.ones_like(a), pt_temp, confs,
                jax.random.fold_in(k_q, 500 + seed), global_moves=True,
            )

        # measure the per-step wall, then match the PA arm's wall
        out, w0 = timed(lambda seed: run(S_Q, seed))
        tau_eq = max(S_Q, int(S_Q * target_wall / max(w0, 1e-9)))
        if tau_eq > S_Q:
            out, _ = timed(lambda seed: run(tau_eq, seed))
        es = np.asarray(qmc.best_slice_energy(problem, out))
        return dict(
            eps_best=float((es.min() - e_gs) / n),
            eps_mean=float((es.mean() - e_gs) / n),
            tau=int(tau_eq),
            wall_baseline_s=w0,
        )

    if p:
        record("opt_piqmc_equalwall_for_paq",
               lambda: arm_piqmc_eq(p["wall_s"]))
    if pa_ad:
        record("opt_piqmc_equalwall_for_paq_adaptive",
               lambda: arm_piqmc_eq(pa_ad["wall_s"]))


def main(outdir="results/pa_value", budget_s=1200):
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)

    problem, e_gs = instances.santoro_80x80(lattice=True)
    key = jax.random.key(23)
    record = make_recorder(path, done, budget_s=budget_s)

    k1, k2, k3 = jax.random.split(key, 3)
    sampling_arms(problem, e_gs, k1, done, record)
    optimization_arms(problem, e_gs, k2, done, record)
    v2_arms(problem, e_gs, k3, done, record)
    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
