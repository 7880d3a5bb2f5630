"""Cluster-update value experiment (VERDICT r3 #2).

Does mixing cluster moves into the flagship anneal improve residual
energy at EQUAL WALL-CLOCK on the accelerator? The reference's cluster
section (qmc.pyx:620-1621) exists on the premise that cluster moves
accelerate mixing; this experiment measures whether that premise
survives the accelerator's cost model, where one local+global sweep
updates a whole chain batch while one Wolff cluster is a data-dependent
loop per chain (bench.py's cluster arm).

Protocol (santoro 80x80, P=40, PT=1 — the benchmark config):
  * baseline(tau): MST-style PIQMC local+global anneal, tau steps.
  * mixed(tau, n_cl): the same anneal cut into n_cl segments with one
    WCL Wolff cluster update per chain between segments (at the segment
    boundary's Gamma). Mean flipped-cluster size is recorded — in a 2D
    +-J spin glass satisfied-bond FK clusters near the percolation point
    flip O(volume) chunks, which is exactly when they stop being useful
    moves, so the size trace explains the result either way.
  * equal-wall baseline: baseline re-run at tau' chosen so its measured
    wall matches the mixed arm's (the honest comparison: cluster moves
    must beat MORE LOCAL SWEEPS, not a time-handicapped baseline).
  * dissipative variant: same design with the bath local engine
    (alpha=1e-2 lookuptable) and the full-SW line-decomposition sweep
    (ops/cluster.sw_full_phase, 10.4 ms/sweep) as the cluster move.

Writes results/cluster_value/summary.json and prints a table. Resume:
completed arms are cached by name and skipped on re-run.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, qmc
from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.bench._common import make_recorder


CHAINS = 32
P = 40
PT = 1.0


def _pre_annealed(problem, key, chains=CHAINS):
    k1, k2 = jax.random.split(key)
    s0 = sa.random_state(k1, problem.nspins, batch=(chains,))
    s0 = sa.anneal(problem, schedules.pre_anneal_schedule(3.0, PT), s0, k2,
                   mcsteps=100)
    return qmc.replicate(s0, P)


def _eps(problem, e_gs, confs):
    es = np.asarray(qmc.best_slice_energy(problem, confs))
    return float((es.mean() - e_gs) / problem.nspins)


def baseline_arm(problem, e_gs, tau, key, confs0, lookuptable=None):
    """tau local(+global / bath) sweeps; returns (eps, wall_s)."""
    a = jnp.asarray(np.linspace(3.0, 1e-8, int(tau), dtype=np.float32))
    kw = (
        dict(lookuptable=lookuptable) if lookuptable is not None
        else dict(global_moves=True)
    )
    out = qmc.anneal(problem, a, jnp.ones_like(a), PT / P, confs0, key, **kw)
    jax.block_until_ready(out)  # compile + warm
    # best-of-2 timed runs
    eps, wall = None, np.inf
    for t in (1, 2):
        t0 = time.time()
        out = qmc.anneal(
            problem, a, jnp.ones_like(a), PT / P, confs0,
            jax.random.fold_in(key, t), **kw
        )
        e = _eps(problem, e_gs, out)  # the host readout waits for the device
        if time.time() - t0 < wall:
            wall = time.time() - t0
        if eps is None:
            eps = e
    return eps, wall


def mixed_arm(problem, e_gs, tau, key, confs0, n_cl=10, lookuptable=None):
    """tau sweeps in n_cl segments + one cluster move per boundary.

    Non-dissipative: WCL Wolff cluster (anneal_wolff, rule="local"),
    vmapped over chains. Dissipative: one full-SW line-decomposition
    sweep (anneal_sw_bath, per_slice_seeds=True).
    Returns (eps, wall_s, mean_flip_fraction).
    """
    a_np = np.linspace(3.0, 1e-8, int(tau), dtype=np.float32)
    seg = int(tau) // n_cl
    kw = (
        dict(lookuptable=lookuptable) if lookuptable is not None
        else dict(global_moves=True)
    )

    def run(confs, key, sync):
        flip_frac = []
        for i in range(n_cl):
            # the LAST segment takes the remainder too — a floor-division
            # slice would silently drop the final (lowest-Gamma) steps for
            # tau % n_cl != 0, biasing the comparison (review r4)
            hi = (i + 1) * seg if i < n_cl - 1 else len(a_np)
            a = jnp.asarray(a_np[i * seg:hi])
            confs = qmc.anneal(
                problem, a, jnp.ones_like(a), PT / P, confs,
                jax.random.fold_in(key, i), **kw
            )
            # hi - 1, not (i+1)*seg - 1: the last segment's slice extends
            # to len(a_np), so its cluster move must run at the TRUE final
            # Gamma, not the un-extended boundary's (review r4)
            g_end = jnp.float32(a_np[hi - 1])
            one = jnp.asarray([g_end])
            kc = jax.random.fold_in(key, 1000 + i)
            if lookuptable is None:
                new = qmc.anneal_wolff(
                    problem, one, jnp.ones(1), PT / P, confs, kc,
                    rule="local",
                )
            else:
                new = qmc.anneal_sw_bath(
                    problem, one, jnp.ones(1), PT / P, lookuptable, confs,
                    kc, per_slice_seeds=True,
                )
            if sync:
                flip_frac.append(
                    float(jnp.mean((new != confs).astype(jnp.float32)))
                )
            confs = new
        return confs, flip_frac

    jax.block_until_ready(run(confs0, key, sync=False)[0])  # compile + warm
    eps, wall = None, np.inf
    for t in (7, 8):  # best-of-2 (see baseline_arm)
        t0 = time.time()
        out, _ = run(confs0, jax.random.fold_in(key, t), sync=False)
        e = _eps(problem, e_gs, out)
        if time.time() - t0 < wall:
            wall = time.time() - t0
        if eps is None:
            eps = e
    # flip sizes measured outside the timed runs (syncs per segment)
    _, flip_frac = run(confs0, jax.random.fold_in(key, 7), sync=True)
    return eps, wall, float(np.mean(flip_frac))


def main(outdir="results/cluster_value", taus=(2000, 6000), budget_s=1500):
    # persistent XLA cache: keeps compiles out of the first arm's timing
    # window on a warm re-run
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)

    problem, e_gs = instances.santoro_80x80(lattice=True)
    key = jax.random.key(0)
    confs0 = _pre_annealed(problem, key)
    lut = schedules.bath_lookuptable(P, 1e-2)
    record = make_recorder(path, done, budget_s=budget_s)

    for tau in taus:
        kp = jax.random.fold_in(key, tau)
        b = record(
            f"baseline_tau{tau}",
            lambda: dict(zip(("eps", "wall_s"),
                             baseline_arm(problem, e_gs, tau, kp, confs0))),
        )
        m = record(
            f"mixed_wcl_tau{tau}",
            lambda: dict(zip(
                ("eps", "wall_s", "flip_frac"),
                mixed_arm(problem, e_gs, tau, kp, confs0),
            )),
        )
        if b and m:
            # equal-wall baseline: scale tau by the measured wall ratio
            tau_eq = int(tau * m["wall_s"] / max(b["wall_s"], 1e-9))
            record(
                f"baseline_equalwall_tau{tau_eq}_for{tau}",
                lambda: dict(zip(
                    ("eps", "wall_s"),
                    baseline_arm(problem, e_gs, tau_eq, kp, confs0),
                )),
            )

    # dissipative variant at one tau (the bath engine is ~3x slower per
    # sweep, and the SW move is cheap now — the most favorable setting
    # for clusters)
    tau = taus[0]
    kp = jax.random.fold_in(key, 90000 + tau)
    b = record(
        f"bath_baseline_tau{tau}",
        lambda: dict(zip(
            ("eps", "wall_s"),
            baseline_arm(problem, e_gs, tau, kp, confs0, lookuptable=lut),
        )),
    )
    m = record(
        f"bath_mixed_sw_tau{tau}",
        lambda: dict(zip(
            ("eps", "wall_s", "flip_frac"),
            mixed_arm(problem, e_gs, tau, kp, confs0, lookuptable=lut),
        )),
    )
    if b and m:
        tau_eq = int(tau * m["wall_s"] / max(b["wall_s"], 1e-9))
        record(
            f"bath_baseline_equalwall_tau{tau_eq}_for{tau}",
            lambda: dict(zip(
                ("eps", "wall_s"),
                baseline_arm(problem, e_gs, tau_eq, kp, confs0,
                             lookuptable=lut),
            )),
        )

    print(json.dumps(done, indent=2))
    return done


if __name__ == "__main__":
    main()
