"""Colored parallel Metropolis sweeps — the data-parallel sweep engine.

Replaces the reference's sequential shuffled single-spin sweep
(sa.pyx:71-99): one sweep = `num_colors` fully-vectorized phases; within a
phase every spin of one independent set is updated simultaneously with exact
Metropolis acceptance. Valid sampler for the same Gibbs measure, race-free,
and maps directly onto vector units (gather + FMA + select) with no
per-spin control flow.

All functions are pure; batching over chains is a plain leading-dim batch
(the analog of the reference's OpenMP read-parallelism, svmc.pyx:624).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def metropolis_accept(de, temp, u):
    """Reference acceptance rule (sa.pyx:96-99): accept iff dE <= 0, else
    with probability exp(-dE/T). Implemented in log form on a zero-free
    uniform — `u < exp(-dE/T)` <=> `-T*log(1-u) > dE` with 1-u in (0,1] —
    because the naive form has an f32 acceptance FLOOR: P(u == 0) = 2^-23
    ~ 1.2e-7 on the float32 uniform grid, so uphill moves whose true
    probability is astronomically small still fire at ~1.2e-7 per
    attempt. Those spurious flips accumulate linearly in tau: measured on
    the 80x80 benchmark, the SA residual-energy curve turned back UP
    beyond tau ~ 2e6 (eps_res 0.0094 @ tau=1e6 -> 0.0122 @ 6e6). The log
    form replaces the floor with a sharp cutoff (moves with p < e^-16
    never fire — immeasurably rare events), restoring monotonicity and
    improving even moderate-tau quality (0.0094 -> 0.0077 at tau = 1e6).
    The reference's `crand()/RAND_MAX` draw has far coarser granularity
    (floor ~3e-5 at RAND_MAX = 32767, sa.pyx:96-99), so this corrects
    rather than deviates. Safe at T = 0: -0.0 * log1p(-u) = 0, which
    never beats an uphill dE.

    The downhill branch compares against `0.0 * temp` (identical to 0.0
    for every finite schedule temperature): a NaN temperature then
    rejects BOTH branches, making a NaN schedule step an exact no-op in
    every XLA engine. bench/mst.py exploits this to pad schedules to a
    few compile-shape buckets (schedules.pad_schedule)."""
    return (de <= 0.0 * temp) | (-temp * jnp.log1p(-u) > de)


# Color loops with at most this many phases are unrolled (best fusion);
# beyond it (dense graphs: a complete graph needs N colors) the loop runs
# as lax.fori so program size stays O(1) in the color count.
MAX_UNROLLED_COLORS = 8


def _color_loop(num_colors, phase_fn, spins):
    if num_colors <= MAX_UNROLLED_COLORS:
        for c in range(num_colors):
            spins = phase_fn(c, spins)
        return spins
    return jax.lax.fori_loop(0, num_colors, phase_fn, spins)


def colored_metropolis_sweep(problem, spins, key, temp, b_coeff=None):
    """One full sweep of single-spin Metropolis updates over all spins.

    Args:
      problem: IsingProblem.
      spins: (..., N) float (+1/-1) state; leading dims are chain batch.
      key: jax PRNG key.
      temp: scalar temperature (traced OK — schedules scan over it).
      b_coeff: optional longitudinal scale; dE = b_coeff * s * field.
        None means classical SA, dE = -2 s (J s + h) (sa.pyx:91-94). PIQMC
        intra-slice sweeps pass b_coeff = -2 * B_sched (qmc.pyx:96).

    Returns:
      Updated spins array, same shape/dtype.
    """
    if b_coeff is None:
        b_coeff = -2.0
    # Color classes partition the sites, so each site's uniform is consumed
    # in exactly one phase — one draw serves the whole sweep.
    u = jax.random.uniform(key, spins.shape)

    def phase(c, spins):
        field = problem.local_fields(spins)
        de = b_coeff * spins * field
        accept = metropolis_accept(de, temp, u) & problem.color_masks[c]
        return jnp.where(accept, -spins, spins)

    return _color_loop(problem.num_colors, phase, spins)


def sweep_scan(problem, spins, key, temps, b_coeffs=None, collect_energy=False):
    """Scan a whole annealing schedule of sweeps in one jitted loop.

    The reference's host-side schedule loop (sa.pyx:66) becomes the scan
    axis. `temps` has one entry per sweep (use schedules.expand_mcsteps for
    mcsteps > 1).

    Returns (spins, energies_or_None).
    """
    temps = jnp.asarray(temps)
    nsteps = temps.shape[0]
    keys = jax.random.split(key, nsteps)

    if b_coeffs is None:
        xs = (temps, keys)

        def body(s, x):
            t, k = x
            s = colored_metropolis_sweep(problem, s, k, t)
            e = problem.energy(s) if collect_energy else None
            return s, e

    else:
        xs = (temps, jnp.asarray(b_coeffs), keys)

        def body(s, x):
            t, b, k = x
            s = colored_metropolis_sweep(problem, s, k, t, b_coeff=b)
            e = problem.energy(s) if collect_energy else None
            return s, e

    spins, es = jax.lax.scan(body, spins, xs)
    return spins, es


def noisy_colored_sweep(problem, nbr_J_t, h_t, spins, key, temp):
    """Sweep with time-dependent couplings (NoisyAnneal, sa.pyx:291-378).

    The per-step coupling table (nbr_J_t: (N, maxnb), h_t: (N,)) overrides
    the problem's static couplings — the schedule axis of the reference's
    4-D `nbs` array (sa.pyx:308-311) becomes a scanned input.
    """
    u = jax.random.uniform(key, spins.shape)

    def phase(c, spins):
        s = spins.astype(nbr_J_t.dtype)
        sj = jnp.take(s, problem.nbr_idx, axis=-1)
        field = jnp.sum(nbr_J_t * sj, axis=-1) + h_t
        de = -2.0 * s * field
        accept = metropolis_accept(de, temp, u) & problem.color_masks[c]
        return jnp.where(accept, -spins, spins)

    return _color_loop(problem.num_colors, phase, spins)
