"""Classical simulated annealing — the JAX analog of sa.pyx.

Capability map to the reference:
  * anneal        <- sa.Anneal (sa.pyx:19-101) and sa.AnnealMA
                     (sa.pyx:108-193): the MA variant's pre-drawn uniform
                     streams are subsumed by counter-based threefry keys —
                     every run is deterministic given `key`.
  * anneal        <- sa.Anneal_parallel (sa.pyx:201-284): the OpenMP racy
    (batched)        prange is replaced by exact colored parallel phases;
                     chain batching replaces thread parallelism.
  * anneal_noisy  <- sa.NoisyAnneal (sa.pyx:291-378): per-schedule-step
                     coupling tables (noise / control trajectories).

All solvers are functional: they return the new state instead of mutating
(the reference flips in place, sa.pyx:44-46). States with extra leading
dimensions are annealed as independent chains.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlosolvers_tpu import schedules as sched_mod

# Default max sweeps per device dispatch (schedules.segments): a very long
# anneal runs as several bounded dispatches, each shipping only its own
# schedule window. bench/mst.py pads schedules against this
# (schedules.pad_schedule) to bucket compile shapes.
SEGMENT = 200_000
from montecarlosolvers_tpu.ops.metropolis import (
    noisy_colored_sweep,
    sweep_scan,
)


# The solver entry points dispatch EAGERLY (outside jit) so engines whose
# setup needs concrete arrays (ops/packed.py's class-major permutation)
# stay reachable; each engine scan below is itself jitted once at module
# scope, so callers pay only Python-level dispatch per call. Calling a
# solver from inside an outer jit still works — traced problems fall back
# to the masked engine (jit-in-jit inlines).
from montecarlosolvers_tpu.ops import packed as packed_ops
from montecarlosolvers_tpu.ops import split as split_ops

_sweep_scan_jit = partial(
    jax.jit, static_argnames=("collect_energy",)
)(sweep_scan)
_split_sa_jit = partial(
    jax.jit, static_argnames=("collect_energy",)
)(split_ops.sa_anneal_split)


def anneal(problem, sched, spins, key, mcsteps=1, collect_energy=False,
           engine="auto", segment=SEGMENT):
    """Thermal anneal over the temperature schedule `sched`.

    Args:
      problem: IsingProblem.
      sched: (schedsize,) temperatures (e.g. schedules.linear(3.0, 0.0, tau),
        the benchmark protocol at examples/santoro80.py:260).
      spins: (..., N) float32 +/-1 starting state; leading dims = chains.
      key: PRNG key; determinism analog of AnnealMA's pre-drawn streams.
      mcsteps: sweeps per schedule step (sa.pyx:68).
      collect_energy: also return per-sweep energies (scan output) — the
        reference exposes no observables (SURVEY.md §5); here they are free
        scan outputs.
      engine: "auto" (dispatch: lattice -> split, packed-eligible graph ->
        packed, else masked) or "masked" to force the masked colored
        engine — the engine a vmapped call (traced problem leaves, e.g.
        parallel/disorder.py) necessarily uses, so solo-vs-vmapped
        bitwise comparisons should pin it.
      segment: max sweeps per device dispatch (schedules.segments): very
        long schedules run as several dispatches with per-segment folded
        keys, so a tau=6e6 anneal is ONE call made of bounded dispatches.
        Schedules that fit one segment keep the unfolded key — bitwise
        identical to the unsegmented behavior. None disables.

    Returns:
      spins (same shape), or (spins, energies) when collect_energy.
    """
    from montecarlosolvers_tpu.models.dense import DenseProblem

    temps = sched_mod.expand_mcsteps(sched, mcsteps)
    segs = sched_mod.segments(temps.shape[0], segment)
    es_parts = []
    for lo, hi in segs:
        k = key if len(segs) == 1 else jax.random.fold_in(key, lo)
        t_seg = temps[lo:hi]
        if isinstance(problem, DenseProblem):
            # fully-connected problems route to the matmul blocked-sequential
            # engine (coloring degenerates on complete graphs)
            from montecarlosolvers_tpu.ops.dense_sweep import dense_anneal

            out = dense_anneal(problem, t_seg, spins, k,
                               collect_energy=collect_energy)
            spins, es = out if collect_energy else (out, None)
        elif engine == "masked":
            spins, es = _sweep_scan_jit(
                problem, spins, k, t_seg, collect_energy=collect_energy
            )
        elif split_ops.supports_split(problem):
            # even-L lattices take the split-checkerboard engine
            # (ops/split.py): maskless half-array phases, zero lane padding
            spins, es = _split_sa_jit(
                problem, t_seg, spins, k, collect_energy=collect_energy
            )
        elif packed_ops.supports_packed(problem):
            # arbitrary graphs: class-major packed layout (ops/packed.py) —
            # maskless block phases, no per-color wasted field/accept work
            spins, es = packed_ops.packed_sweep_scan(
                problem, spins, k, t_seg, collect_energy=collect_energy
            )
        else:
            spins, es = _sweep_scan_jit(
                problem, spins, k, t_seg, collect_energy=collect_energy
            )
        if collect_energy:
            es_parts.append(es)
    if collect_energy:
        es = es_parts[0] if len(es_parts) == 1 else jnp.concatenate(es_parts)
        return spins, es
    return spins


@jax.jit
def _noisy_masked_scan(problem, temps, nbr_J_sched, h_sched, spins, key):
    keys = jax.random.split(key, temps.shape[0])

    def body(s, x):
        t, jt, ht, k = x
        return noisy_colored_sweep(problem, jt, ht, s, k, t), None

    spins, _ = jax.lax.scan(body, spins, (temps, nbr_J_sched, h_sched, keys))
    return spins


def anneal_noisy(problem, sched, nbr_J_sched, h_sched, spins, key, mcsteps=1):
    """Thermal anneal with time-dependent couplings (sa.NoisyAnneal,
    sa.pyx:291-378).

    nbr_J_sched: (schedsize, N, maxnb) per-step quadratic couplings.
    h_sched:     (schedsize, N) per-step local fields.
    The reference's 4-D nbs array (noise or control trajectory per step,
    sa.pyx:308-311) maps to these two scanned tables.
    """
    temps = sched_mod.expand_mcsteps(sched, mcsteps)
    nbr_J_sched = jnp.repeat(nbr_J_sched, mcsteps, axis=0) if mcsteps > 1 else nbr_J_sched
    h_sched = jnp.repeat(h_sched, mcsteps, axis=0) if mcsteps > 1 else h_sched

    if packed_ops.supports_packed(problem):
        return packed_ops.packed_noisy_scan(
            problem, temps, nbr_J_sched, h_sched, spins, key
        )
    return _noisy_masked_scan(problem, temps, nbr_J_sched, h_sched, spins, key)


def anneal_wolff(problem, sched, spins, key, mcsteps=1, local_sweeps=True):
    """Classical annealing/sampling with Wolff cluster updates — a
    beyond-reference extension (the reference's cluster moves exist only
    for PIQMC, qmc.pyx:620-1000; its classical solver is local-only).

    Reuses the space-time FK cluster engine (ops/cluster.py) on a
    single-slice configuration: at Gamma = inf, J_perp is exactly 0, so
    the satisfied-bond draw contains spatial bonds only — textbook
    classical Wolff (p = 1 - exp(-2|J|/T) on satisfied bonds) with the
    standard Metropolis field correction. One cluster per chain per
    schedule step; local_sweeps=True precedes each cluster with a colored
    Metropolis sweep (the production mix — bench/cluster_crossover.py
    measures where clusters pay).

    spins: (..., N). Fixed-temperature sampling = a constant schedule.
    """
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    return _anneal_wolff_impl(problem, sched, spins, key, mcsteps=mcsteps,
                              local_sweeps=local_sweeps)


@partial(jax.jit, static_argnames=("mcsteps", "local_sweeps"))
def _anneal_wolff_impl(problem, sched, spins, key, mcsteps=1,
                       local_sweeps=True):
    from montecarlosolvers_tpu.ops import cluster as cluster_ops
    from montecarlosolvers_tpu.ops.metropolis import colored_metropolis_sweep

    temps = sched_mod.expand_mcsteps(sched, mcsteps)
    keys = jax.random.split(key, temps.shape[0])
    orig = spins.shape
    s = spins.reshape(-1, orig[-1])
    chains = s.shape[0]

    def one_cluster(c, k, t):
        return cluster_ops.wolff_update(
            problem, c[None, :], k, t, jnp.inf, 1.0, rule="local")[0]

    wolff_v = jax.vmap(one_cluster, in_axes=(0, 0, None))

    def body(s, x):
        t, k = x
        k1, k2 = jax.random.split(k)
        if local_sweeps:
            s = colored_metropolis_sweep(problem, s, k1, t)
        s = wolff_v(s, jax.random.split(k2, chains), t)
        return s, None

    s, _ = jax.lax.scan(body, s, (temps, keys))
    return s.reshape(orig)


def anneal_sw(problem, sched, spins, key, mcsteps=1, local_sweeps=False):
    """Classical Swendsen-Wang annealing/sampling — every FK cluster of
    the whole lattice updates each step for roughly the cost of ONE Wolff
    cluster's BFS (ops/cluster.classical_sw_sweep; measured crossover
    study: bench/cluster_crossover.py). Beyond-reference:
    the reference has no classical cluster solver at all.

    local_sweeps=True interleaves a colored Metropolis sweep before each
    SW sweep. Fixed-temperature sampling = a constant schedule.
    spins: (..., N). LatticeProblems are converted to the neighbor-table
    form (the generic min-label relax; see
    ops/cluster._label_components_lattice for the trade-off). Call
    ops/cluster.classical_sw_sweep_lattice directly to opt in to the
    scan labeler.
    """
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    return _anneal_sw_impl(problem, sched, spins, key, mcsteps=mcsteps,
                           local_sweeps=local_sweeps)


@partial(jax.jit, static_argnames=("mcsteps", "local_sweeps"))
def _anneal_sw_impl(problem, sched, spins, key, mcsteps=1,
                    local_sweeps=False):
    from montecarlosolvers_tpu.ops import cluster as cluster_ops
    from montecarlosolvers_tpu.ops.metropolis import colored_metropolis_sweep

    temps = sched_mod.expand_mcsteps(sched, mcsteps)
    keys = jax.random.split(key, temps.shape[0])
    orig = spins.shape
    s = spins.reshape(-1, orig[-1])
    chains = s.shape[0]

    sw_v = jax.vmap(
        lambda c, k, t: cluster_ops.classical_sw_sweep(problem, c, k, t),
        in_axes=(0, 0, None),
    )

    def body(s, x):
        t, k = x
        k1, k2 = jax.random.split(k)
        if local_sweeps:
            s = colored_metropolis_sweep(problem, s, k1, t)
        s = sw_v(s, jax.random.split(k2, chains), t)
        return s, None

    s, _ = jax.lax.scan(body, s, (temps, keys))
    return s.reshape(orig)


def random_state(key, nspins, batch=()):
    """Random +/-1 initial configuration(s) (examples/santoro80.py:259)."""
    shape = tuple(batch) + (nspins,)
    return jax.random.choice(key, jnp.array([-1.0, 1.0], dtype=jnp.float32), shape)
