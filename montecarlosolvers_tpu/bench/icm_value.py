"""ICM value experiment (round 5; VERDICT r4 missing #1).

bench/pt_value.py measures ICM (Houdayer cluster moves + parallel
tempering, solvers/pt.sample_icm) on the 2D santoro benchmark, a
landscape where the cluster phases are not expected to pay. The spin-glass literature's claim
(Houdayer 2001; Zhu, Ochoa, Katzgraber 2015) is that the moves pay on
3D Edwards-Anderson-class landscapes — valleys separated by system-wide
droplets that local+exchange dynamics cannot cross. This experiment
measures that claim on the accelerator at equal WALL-CLOCK:

  * Instances: 3D EA +/-J, L in {8, 10, 12, 14} periodic
    (models/instances.random_3d_lattice), several disorder seeds with
    several independent repetitions each (hitting times are
    heavy-tailed). T_c ~ 1.1; the ladder's cold end sits far below
    (0.3). SK is deliberately excluded: on a complete graph the q = -1
    overlap domain is a single component, so the Houdayer move
    degenerates to a relabeling (sample_icm docstring) — there is no
    sparse structure for the cluster to exploit.
  * Arms per instance: ICM at Houdayer cadences {2, 8, 32} sweeps
    ({8, 32} at the frontier size), and the PT-only baseline = the SAME
    sampler with houdayer_every=0 (the two ladders run independent PT
    through the identical code path, so the Houdayer phases are the
    ONLY difference).
  * Equal wall: every arm runs in SEG-sweep segments with per-segment
    cumulative best energy and wall recorded; the PT baseline runs until
    it has covered the slowest ICM arm's wall, so any ICM point can be
    compared against PT's best at the same (or larger) wall.
  * Mechanism metrics: Houdayer flip fraction (the q = -1 domain mass
    that actually moves), swap rates, measured per-phase cluster cost
    (the jump-labeling path, ops/cluster._label_components jump_every).

Metric: best energy ever found (any rung, any ladder; per-sweep energies
are collected, so time-to-target curves come for free), plus the cold-
rung sampling mean over the final half. e_ref per instance = best energy
any arm ever found; +/-J energies are integer-quantized so hitting e_ref
exactly is meaningful.

Writes results/icm_value/summary.json (resume-cached by arm name).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, pt
from montecarlosolvers_tpu.bench._common import make_recorder


L_SIZES = (8, 10, 12, 14)
SEEDS_BY_L = {8: (0, 1, 2, 3, 4), 10: (0, 1, 2, 3, 4),
              12: (0, 1, 2, 3, 4), 14: (0, 1, 2, 3, 4)}
RUNGS = 24
SEG = 500            # sweeps per segment (one device dispatch)
# deeper runs for the harder sizes (per-L segment count)
ICM_SEGS = {8: 8, 10: 12, 12: 36, 14: 48}
# cadence h2 pays double cluster overhead; at the frontier size keep the
# cadences the smaller sizes showed to be competitive
CADENCES_BY_L = {8: (2, 8, 32), 10: (2, 8, 32), 12: (2, 8, 32),
                 14: (8, 32)}
# independent repetitions per (instance, arm): ground-state hitting times
# are heavy-tailed, so single runs flip-flop between winners; the verdict
# aggregates PAIRED (icm, pt) hitting times over seeds x reps
REPS = {8: 1, 10: 3, 12: 5, 14: 3}
T_COLD, T_HOT = 0.3, 1.6


def _run_segments(problem, temps, s0, key, n_segs, houdayer_every,
                  max_wall=None, grid_bonds=None):
    """Run sample_icm in SEG-sweep segments, carrying states; returns a
    per-segment record list and the final states. Stops early when
    max_wall (seconds of accumulated measured wall) is exceeded."""
    states = s0
    recs = []
    e_best = np.inf
    wall = 0.0
    for seg in range(n_segs):
        k = jax.random.fold_in(key, seg)
        t0 = time.time()
        states, rate, hfrac, es = pt.sample_icm(
            problem, temps, states, k, SEG, swap_every=2,
            houdayer_every=houdayer_every, collect_energy=True,
            grid_bonds=grid_bonds,
        )
        es = np.asarray(es)  # (SEG, 2, M) rung-ordered
        dt = time.time() - t0
        wall += dt
        e_best = min(e_best, float(es.min()))
        recs.append(dict(
            wall_s=round(wall, 3),
            sweeps=(seg + 1) * SEG,
            e_best=e_best,
            e_cold=float(es[SEG // 2:, :, 0].mean()),
            swap_rate=float(rate),
            h_frac=float(hfrac),
        ))
        if max_wall is not None and wall >= max_wall:
            break
    return recs, states


def run_instance(L, seed, key, record):
    from montecarlosolvers_tpu.ops.cluster import grid_bonds_from_edges

    problem, (rows, cols, vals) = instances.random_3d_lattice(
        L, rng=seed, dist="pm1"
    )
    gb = grid_bonds_from_edges((L, L, L), rows, cols, vals)
    n = problem.nspins
    k_init, k_tune, k_run = jax.random.split(key, 3)
    s0 = sa.random_state(k_init, n, batch=(2, RUNGS))

    def arm_tune():
        temps0 = pt.geometric_ladder(T_COLD, T_HOT, RUNGS)
        temps, pair_rates = pt.tune_ladder(
            problem, temps0, k_tune, rounds=3, sweeps_per_round=200
        )
        return dict(
            temps=[float(t) for t in np.asarray(temps)],
            pair_rate_min=float(np.min(pair_rates)),
            pair_rate_mean=float(np.mean(pair_rates)),
        )

    tune = record(f"tune_L{L}_s{seed}", arm_tune)
    if tune is None:
        return
    temps = jnp.asarray(tune["temps"], jnp.float32)

    # --- ICM arms, one per cadence x rep --------------------------------
    max_wall = 0.0
    for h in CADENCES_BY_L[L]:
        for rep in range(REPS[L]):
            def arm_icm(h=h, rep=rep):
                # warm segment (compile) outside the recorded walls
                _ = _run_segments(problem, temps, s0,
                                  jax.random.fold_in(k_run, 9000 + h), 1, h,
                                  grid_bonds=gb)
                recs, _ = _run_segments(
                    problem, temps, s0,
                    jax.random.fold_in(k_run, 1000 * rep + h),
                    ICM_SEGS[L], h, grid_bonds=gb,
                )
                return dict(segments=recs)

            suffix = f"_r{rep}" if rep else ""
            out = record(f"icm_h{h}_L{L}_s{seed}{suffix}", arm_icm)
            if out:
                max_wall = max(max_wall, out["segments"][-1]["wall_s"])

    # --- PT baseline: same code path, no Houdayer, run to max ICM wall --
    for rep in range(REPS[L]):
        def arm_pt(rep=rep):
            _ = _run_segments(problem, temps, s0,
                              jax.random.fold_in(k_run, 9999), 1, 0)
            # cover the slowest ICM arm's wall with margin (cap the
            # segment count so a mis-measured wall cannot run away)
            recs, _ = _run_segments(
                problem, temps, s0,
                jax.random.fold_in(k_run, 1000 * rep + 7),
                n_segs=400, houdayer_every=0,
                max_wall=max(max_wall * 1.1, 1.0),
            )
            return dict(segments=recs)

        suffix = f"_r{rep}" if rep else ""
        record(f"pt_L{L}_s{seed}{suffix}", arm_pt)


def _arm_keys(done, prefix):
    """All rep keys for an arm, rep 0 unsuffixed (resume-compat)."""
    keys = [k for k in done
            if k == prefix or k.startswith(prefix + "_r")]
    return sorted(keys)


def summarize(done):
    """Paired equal-wall verdict: per (L, cadence), every (seed, rep)
    pairs one ICM run against one PT run with the same stream index;
    the pair's winner is decided by ground-state hitting (reached/not,
    then wall-to-reference at segment granularity). Heavy-tailed hitting
    times make single runs flip-flop, so the verdict is the paired win
    count plus median hitting walls over all pairs."""
    out = {}
    for L in L_SIZES:
        n = L ** 3
        for h in CADENCES_BY_L[L]:
            pairs = []
            h_fracs = []
            for seed in SEEDS_BY_L[L]:
                pt_keys = _arm_keys(done, f"pt_L{L}_s{seed}")
                icm_keys = _arm_keys(done, f"icm_h{h}_L{L}_s{seed}")
                if not pt_keys or not icm_keys:
                    continue
                # instance reference energy: best ANY arm of ANY cadence
                # ever found on this (L, seed)
                e_ref = np.inf
                tag = f"_L{L}_s{seed}"
                for k, v in done.items():
                    if (isinstance(v, dict) and "segments" in v
                            and (k.endswith(tag) or f"{tag}_r" in k)):
                        e_ref = min(
                            e_ref, min(r["e_best"] for r in v["segments"])
                        )

                def wall_to_ref(recs):
                    for rec in recs:
                        if rec["e_best"] <= e_ref:
                            return rec["wall_s"]
                    return None

                for ik, pk in zip(icm_keys, pt_keys):
                    i_ttr = wall_to_ref(done[ik]["segments"])
                    p_ttr = wall_to_ref(done[pk]["segments"])
                    i_eps = (done[ik]["segments"][-1]["e_best"] - e_ref) / n
                    p_eps = (done[pk]["segments"][-1]["e_best"] - e_ref) / n
                    h_fracs.append(done[ik]["segments"][-1]["h_frac"])
                    if i_ttr is not None and p_ttr is None:
                        win = "icm"
                    elif p_ttr is not None and i_ttr is None:
                        win = "pt"
                    elif i_ttr is not None and p_ttr is not None:
                        win = ("icm" if i_ttr < p_ttr
                               else "pt" if p_ttr < i_ttr else "tie")
                    else:
                        win = ("icm" if i_eps < p_eps
                               else "pt" if p_eps < i_eps else "tie")
                    pairs.append(dict(
                        pair=f"s{len(pairs)}", icm_ttr=i_ttr, pt_ttr=p_ttr,
                        icm_eps=round(i_eps, 6), pt_eps=round(p_eps, 6),
                        winner=win,
                    ))
            if not pairs:
                continue
            wins = [p["winner"] for p in pairs]
            i_hits = [p["icm_ttr"] for p in pairs if p["icm_ttr"] is not None]
            p_hits = [p["pt_ttr"] for p in pairs if p["pt_ttr"] is not None]
            out[f"L{L}_h{h}"] = dict(
                pairs=len(pairs),
                icm_wins=wins.count("icm"),
                pt_wins=wins.count("pt"),
                ties=wins.count("tie"),
                icm_hit_frac=round(len(i_hits) / len(pairs), 3),
                pt_hit_frac=round(len(p_hits) / len(pairs), 3),
                icm_median_ttr=(round(float(np.median(i_hits)), 3)
                                if i_hits else None),
                pt_median_ttr=(round(float(np.median(p_hits)), 3)
                               if p_hits else None),
                h_frac_mean=round(float(np.mean(h_fracs)), 4),
            )
    return out


def main(outdir="results/icm_value", budget_s=2400):
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "summary.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    record = make_recorder(path, done, budget_s=budget_s)

    key = jax.random.key(5)
    for L in L_SIZES:
        for seed in SEEDS_BY_L[L]:
            run_instance(L, seed, jax.random.fold_in(key, 100 * L + seed),
                         record)

    done["equal_wall_verdicts"] = summarize(done)
    with open(path, "w") as f:
        json.dump(done, f, indent=2)
    print(json.dumps(done["equal_wall_verdicts"], indent=2))
    return done


if __name__ == "__main__":
    main()
