"""High-level one-call solving API.

The reference's "API by example" is a hand-rolled driver script
(examples/santoro80.py); production users expect a sampler-style entry
point. `solve` wraps the solver families behind presets and returns a
`SampleSet` (samples sorted by energy, like contemporary annealer SDKs).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.solvers import sa as sa_mod
from montecarlosolvers_tpu.solvers import qmc as qmc_mod
from montecarlosolvers_tpu.solvers import svmc as svmc_mod
from montecarlosolvers_tpu.solvers import pt as pt_mod


@dataclasses.dataclass(frozen=True)
class SampleSet:
    """Solve result: states sorted by energy (ascending)."""

    samples: np.ndarray   # (num_reads, N) +/-1
    energies: np.ndarray  # (num_reads,)
    info: dict

    @property
    def best(self):
        return self.samples[0]

    @property
    def best_energy(self):
        return float(self.energies[0])

    def __len__(self):
        return self.samples.shape[0]


def _finalize(problem, states, info, energies=None):
    states = np.asarray(states)
    if energies is None:
        energies = np.asarray(problem.energy(jnp.asarray(states)))
    else:
        energies = np.asarray(energies)
    order = np.argsort(energies)
    return SampleSet(states[order], energies[order], info)


_METHOD_KW = {
    "sa": {"t_start", "t_end"},
    "sa_wolff": {"t_start", "t_end", "local_sweeps"},
    "sa_sw": {"t_start", "t_end", "local_sweeps"},
    "piqmc": {"slices", "pt", "field_start", "pre_anneal"},
    "piqmc_wolff": {"slices", "pt", "field_start", "pre_anneal", "rule",
                    "alpha"},
    "piqmc_sw": {"slices", "pt", "field_start", "pre_anneal", "alpha",
                 "per_slice_seeds"},
    "piqmc_sw_full": {"slices", "pt", "field_start", "pre_anneal", "alpha",
                      "local_sweeps"},
    "svmc": {"field_start", "temp"},
    "pt": {"t_min", "t_max", "ladder"},
    "icm": {"t_min", "t_max", "ladder", "houdayer_every"},
    "pa": {"beta_end", "mcsteps", "ess_threshold", "adaptive",
           "target_frac"},
    "paq": {"beta_end", "slices", "pt", "field_start", "mcsteps",
            "ess_threshold"},
}


def _auto_ladder(n, t_min, t_max):
    """Rung count so adjacent rungs' energy distributions overlap: rung
    ratio - 1 must scale like 1/sqrt(N) (see pt.geometric_ladder).
    c = 2.5 is calibrated by a measured table, not one anchor
    (results/ladder_calibration): the auto-sized ladder
    lands swap rates 0.37-0.46 at N in {256, 1024, 6400, 16384} on 2D
    Gaussian lattices AND N in {256, 1024, 2048} on SK — every point
    inside the 20-60% target band (tests/test_api.py asserts the band
    at the CPU-sized points). A fixed rung count collapses to ~0
    exchange at large N."""
    return max(4, int(np.ceil(
        np.log(t_max / t_min) * np.sqrt(n) / 2.5
    )) + 1)


def solve(problem, method="sa", num_reads=64, sweeps=1000, seed=0, **kw):
    """Anneal `num_reads` independent trajectories and return a SampleSet.

    method:
      "sa"    — classical simulated annealing; kw: t_start=3.0, t_end=0.0.
      "sa_wolff" — classical annealing with one Wolff cluster per sweep
                (local_sweeps=True mixes colored sweeps in); best for
                ferromagnetic / weakly frustrated problems near
                criticality (bench/cluster_crossover.py).
      "sa_sw" — classical Swendsen-Wang (full-lattice cluster update per
                sweep); same kw as sa_wolff.
      "piqmc" — MST path-integral QMC with global moves; kw: slices=20,
                pt=1.0, field_start=3.0, pre_anneal=True.
      "piqmc_wolff" — PIQMC with Wolff cluster updates (one space-time
                cluster per sweep); kw: piqmc's + rule="local"|"full",
                alpha (bath coupling; adds bath bonds when set).
      "piqmc_sw" — dissipative PIQMC with SW bath clusters; kw: piqmc's
                + alpha=1e-3, per_slice_seeds=True.
      "piqmc_sw_full" — PIQMC with FULL space-time Swendsen-Wang sweeps
                (every FK cluster per step, qmc.anneal_sw); kw: piqmc's
                + alpha (optional bath bonds), local_sweeps=True.
      "svmc"  — spin-vector MC with TF proposals; kw: field_start=3.0,
                temp=0.05.
      "pt"    — parallel tempering; kw: t_min=0.1, t_max=3.0, ladder=None
                (auto-sized so adjacent rungs overlap: rung ratio - 1
                ~ 2.5/sqrt(N), targeting a 20-60% swap rate; pass an int
                to override). num_reads independent ladders are run; the
                coldest rung of each is returned.
      "icm"   — parallel tempering with isoenergetic (Houdayer) cluster
                moves between paired ladders (pt.sample_icm); kw: pt's +
                houdayer_every=2. Sparse/lattice problems only; best on
                frustrated instances where plain PT stalls.
      "pa"    — population annealing (pa.sample): num_reads is the
                population size, annealed down a beta-linear schedule
                from beta=0 (uniform random = exact equilibrium) with
                per-step resampling; kw: beta_end=10.0, mcsteps=1,
                ess_threshold=1.0, adaptive=False (True: on-device
                ESS-targeted dbeta steps via pa.sample_adaptive, with
                target_frac=0.9 and `sweeps` as the step cap). info
                carries the absolute ln Z estimate and the minimum ESS
                fraction (+ n_steps/reached/families when adaptive).
      "paq"   — quantum population annealing (pa.sample_piqmc):
                num_reads path configurations (R, P, N) annealed down a
                transverse-field schedule with extended-ensemble
                resampling; kw: slices=20, pt=1.0, field_start=2.5,
                mcsteps=1, ess_threshold=1.0. Returns each path's best
                slice.
    """
    if method not in _METHOD_KW:
        raise ValueError(f"unknown method: {method}")
    unknown = set(kw) - _METHOD_KW[method]
    if unknown:
        raise TypeError(
            f"solve(method={method!r}) got unexpected options {sorted(unknown)}; "
            f"accepted: {sorted(_METHOD_KW[method])}"
        )

    key = jax.random.key(seed)
    n = problem.nspins
    info = dict(method=method, num_reads=num_reads, sweeps=sweeps, seed=seed)

    if method in ("sa", "sa_wolff", "sa_sw"):
        k_init, k_run = jax.random.split(key)
        # cluster bond probabilities degenerate at T = 0 (every satisfied
        # bond activates), so the cluster anneals stop at a small floor
        sched = schedules.linear(
            kw.get("t_start", 3.0),
            kw.get("t_end", 0.0 if method == "sa" else 0.05), sweeps)
        s0 = sa_mod.random_state(k_init, n, batch=(num_reads,))
        if method == "sa":
            out = sa_mod.anneal(problem, sched, s0, k_run)
        elif method == "sa_wolff":
            out = sa_mod.anneal_wolff(
                problem, sched, s0, k_run,
                local_sweeps=kw.get("local_sweeps", True))
        else:
            out = sa_mod.anneal_sw(
                problem, sched, s0, k_run,
                local_sweeps=kw.get("local_sweeps", True))
        return _finalize(problem, out, info)

    if method in ("piqmc", "piqmc_wolff", "piqmc_sw", "piqmc_sw_full"):
        slices = kw.get("slices", 20)
        pt = kw.get("pt", 1.0)
        k1, k2, k3 = jax.random.split(key, 3)
        s0 = sa_mod.random_state(k1, n, batch=(num_reads,))
        if kw.get("pre_anneal", True):
            # protocol-grade pre-anneal: 100 sweeps per 0.05-step (the MST
            # driver's setting, examples/santoro80.py:284-285); costs only
            # ~4100 classical sweeps and measurably improves quality at
            # fixed Gamma-sweep budget (tests/test_api.py quality test)
            pre = schedules.pre_anneal_schedule(3.0, pt)
            s0 = sa_mod.anneal(problem, pre, s0, k2, mcsteps=100)
        confs = qmc_mod.replicate(s0, slices)
        a = schedules.transverse_field(kw.get("field_start", 3.0), 1e-8,
                                       sweeps)
        b = jnp.ones_like(a)
        if method == "piqmc":
            confs = qmc_mod.anneal(problem, a, b, pt / slices, confs, k3,
                                   global_moves=True)
        elif method == "piqmc_wolff":
            lut = (
                schedules.bath_lookuptable(slices, kw["alpha"])
                if "alpha" in kw else None
            )
            confs = qmc_mod.anneal_wolff(
                problem, a, b, pt / slices, confs, k3,
                rule=kw.get("rule", "local"), lookuptable=lut,
            )
        elif method == "piqmc_sw":
            lut = schedules.bath_lookuptable(slices, kw.get("alpha", 1e-3))
            confs = qmc_mod.anneal_sw_bath(
                problem, a, b, pt / slices, lut, confs, k3,
                per_slice_seeds=kw.get("per_slice_seeds", True),
            )
        else:  # piqmc_sw_full: global space-time SW decomposition
            lut = (
                schedules.bath_lookuptable(slices, kw["alpha"])
                if "alpha" in kw else None
            )
            confs = qmc_mod.anneal_sw(
                problem, a, b, pt / slices, confs, k3, lookuptable=lut,
                local_sweeps=kw.get("local_sweeps", True),
            )
        # best slice per read; energies already known — skip re-evaluation
        es = np.asarray(problem.energy(confs))  # (reads, P)
        best_k = es.argmin(axis=-1)
        states = np.asarray(confs)[np.arange(num_reads), best_k]
        return _finalize(problem, states, info,
                         energies=es[np.arange(num_reads), best_k])

    if method == "svmc":
        k_init, k_run = jax.random.split(key)
        a = schedules.linear(kw.get("field_start", 3.0), 1e-8, sweeps)
        th = svmc_mod.random_state(k_init, n, batch=(num_reads,))
        out = svmc_mod.anneal(problem, a, jnp.ones_like(a),
                              kw.get("temp", 0.05), th, k_run, tf=True)
        return _finalize(problem, svmc_mod.z_projection(out), info)

    if method == "pa":
        from montecarlosolvers_tpu.solvers import pa as pa_mod

        k_init, k_run = jax.random.split(key)
        states = sa_mod.random_state(k_init, n, batch=(num_reads,))
        if kw.get("adaptive"):
            out, log_z, stats = pa_mod.sample_adaptive(
                problem, kw.get("beta_end", 10.0), states, k_run,
                target_frac=kw.get("target_frac", 0.9),
                mcsteps=kw.get("mcsteps", 1), max_steps=sweeps,
            )
            info["n_steps"] = stats["n_steps"]
            info["reached"] = stats["reached"]
            info["families"] = stats["families"]
        else:
            temps = pa_mod.beta_linear(kw.get("beta_end", 10.0), sweeps,
                                       beta_start=0.0)
            out, log_z, stats = pa_mod.sample(
                problem, temps, states, k_run,
                mcsteps=kw.get("mcsteps", 1), beta0=0.0,
                ess_threshold=kw.get("ess_threshold", 1.0),
                collect_stats=True,
            )
        info["log_z"] = float(log_z) + pa_mod.uniform_log_z(n)
        info["min_ess_frac"] = float(np.asarray(stats["ess"]).min()) / num_reads
        return _finalize(problem, out, info)

    if method == "paq":
        from montecarlosolvers_tpu.solvers import pa as pa_mod

        k_init, k_run = jax.random.split(key)
        slices = kw.get("slices", 20)
        pt_v = kw.get("pt", 1.0)
        temp = pt_v / slices
        confs = jnp.where(
            jax.random.bernoulli(k_init, 0.5, (num_reads, slices, n)),
            1.0, -1.0,
        )
        gammas = schedules.transverse_field(
            kw.get("field_start", 2.5), 1e-8, sweeps
        )
        confs, log_z, stats = pa_mod.sample_piqmc(
            problem, gammas, temp, confs, k_run,
            mcsteps=kw.get("mcsteps", 1),
            ess_threshold=kw.get("ess_threshold", 1.0),
            global_moves=True, collect_stats=True,
        )
        info["families"] = stats["families"]
        info["min_ess_frac"] = (
            float(np.asarray(stats["ess"]).min()) / num_reads
        )
        # best slice per path configuration, reference readout convention
        best = jax.vmap(
            lambda c: c[jnp.argmin(problem.energy(c))]
        )(confs)
        return _finalize(problem, best, info)

    t_min, t_max = kw.get("t_min", 0.1), kw.get("t_max", 3.0)
    ladder = kw.get("ladder")
    if ladder is None:
        ladder = _auto_ladder(n, t_min, t_max)
        info["ladder"] = ladder
    temps = pt_mod.geometric_ladder(t_min, t_max, ladder)

    if method == "icm":
        # each read is ONE ladder of an ICM pair: run ceil(reads/2)
        # two-ladder runs, return every ladder's coldest rung
        pairs = (num_reads + 1) // 2
        k_init, k_run = jax.random.split(key)
        keys = jax.random.split(k_run, pairs)
        states = sa_mod.random_state(k_init, n, batch=(pairs, 2, ladder))
        outs, rates, hfracs = jax.vmap(
            lambda s, k: pt_mod.sample_icm(
                problem, temps, s, k, sweeps, swap_every=2,
                houdayer_every=kw.get("houdayer_every", 2),
            )
        )(states, keys)
        info["mean_swap_rate"] = float(np.asarray(rates).mean())
        info["houdayer_flip_frac"] = float(np.asarray(hfracs).mean())
        cold = np.asarray(outs)[:, :, 0].reshape(2 * pairs, n)
        return _finalize(problem, cold[:num_reads], info)

    # method == "pt"
    k_init, k_run = jax.random.split(key)
    keys = jax.random.split(k_run, num_reads)
    states = sa_mod.random_state(k_init, n, batch=(num_reads, ladder))
    outs, rates = jax.vmap(
        lambda s, k: pt_mod.sample(problem, temps, s, k, sweeps)
    )(states, keys)
    info["mean_swap_rate"] = float(np.asarray(rates).mean())
    return _finalize(problem, np.asarray(outs)[:, 0], info)
