"""Spin-vector Monte Carlo annealing — the JAX analog of svmc.pyx.

Capability map to the reference:
  anneal(tf=False)        <- svmc.SpinVectorMonteCarlo (svmc.pyx:21-117)
  anneal(tf=True)         <- svmc.SpinVectorMonteCarloTF (svmc.pyx:123-229)
  anneal_noisy(tf=False)  <- svmc.NoisySVMC (svmc.pyx:236-334)
  anneal_noisy(tf=True)   <- svmc.NoisySVMCTF (svmc.pyx:340-448)
  anneal on (R, N) states <- svmc.SpinVectorMonteCarloCompact /
                             SpinVectorMonteCarloTFCompact (svmc.pyx:455-674):
                             the reference's "numreads" batch (serial loop at
                             svmc.pyx:514, hard-coded 6 OpenMP threads at
                             svmc.pyx:624) is simply a leading batch axis
                             here — thousands of reads per chip.
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
SEGMENT = 100_000
from montecarlosolvers_tpu.ops import svmc_ops
from montecarlosolvers_tpu.ops import packed as packed_ops
from montecarlosolvers_tpu.ops import split as split_ops

# Entry points dispatch eagerly (ops/packed.py needs concrete arrays to
# build its layout); the engine scans are jitted once at module scope.
_split_svmc_jit = partial(
    jax.jit, static_argnames=("tf", "collect_energy")
)(split_ops.svmc_anneal_split)


@partial(jax.jit, static_argnames=("tf", "collect_energy"))
def _masked_svmc_scan(problem, a, b, temp, theta, key, tf=False,
                      collect_energy=False):
    keys = jax.random.split(key, a.shape[0])

    def body(state, x):
        ac, bc, k = x
        state = svmc_ops.svmc_sweep_cached(problem, state, k, temp, ac, bc, tf=tf)
        e = (
            problem.energy(svmc_ops.z_projection_from_cos(state[1]))
            if collect_energy else None
        )
        return state, e

    state0 = (theta, jnp.cos(theta), jnp.sin(theta))
    (theta, _, _), es = jax.lax.scan(body, state0, (a, b, keys))
    return theta, es


@partial(jax.jit, static_argnames=("tf",))
def _masked_noisy_svmc_scan(problem, a, b, temp, nbr_J_sched, h_sched,
                            theta, key, tf=False):
    keys = jax.random.split(key, a.shape[0])

    def body(state, x):
        ac, bc, jt, ht, k = x
        state = svmc_ops.noisy_svmc_sweep_cached(
            problem, jt, ht, state, k, temp, ac, bc, tf=tf
        )
        return state, None

    state0 = (theta, jnp.cos(theta), jnp.sin(theta))
    (theta, _, _), _ = jax.lax.scan(
        body, state0, (a, b, nbr_J_sched, h_sched, keys)
    )
    return theta


def anneal(problem, a_sched, b_sched, temp, theta, key, mcsteps=1, tf=False,
           collect_energy=False, segment=SEGMENT):
    """SVMC anneal over (A, B) schedules at fixed temperature.

    theta: (..., N) rotor angles in [0, pi]; leading dims are reads/chains.
    tf=True uses transverse-field-informed proposals (svmc.pyx:198-207).
    collect_energy emits per-sweep z-projected classical energies.
    segment: max sweeps per device dispatch (schedules.segments) — very
    long schedules run as several bounded dispatches with per-segment
    folded keys. One-segment schedules keep the unfolded key. None
    disables.
    Returns the annealed angles; project with ops.svmc_ops.z_projection.
    """
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)

    segs = sched_mod.segments(a.shape[0], segment)
    es_parts = []
    for lo, hi in segs:
        k = key if len(segs) == 1 else jax.random.fold_in(key, lo)
        if split_ops.supports_split(problem):
            # even-L lattices: maskless split-checkerboard engine
            # (ops/split.py)
            theta, es = _split_svmc_jit(
                problem, a[lo:hi], b[lo:hi], temp, theta, k, tf=tf,
                collect_energy=collect_energy,
            )
        elif packed_ops.supports_packed(problem):
            # arbitrary graphs: class-major packed layout (ops/packed.py)
            theta, es = packed_ops.packed_svmc_scan(
                problem, a[lo:hi], b[lo:hi], temp, theta, k, tf=tf,
                collect_energy=collect_energy,
            )
        else:
            theta, es = _masked_svmc_scan(
                problem, a[lo:hi], b[lo:hi], temp, theta, k, tf=tf,
                collect_energy=collect_energy,
            )
        if collect_energy:
            es_parts.append(es)
    if collect_energy:
        es = es_parts[0] if len(es_parts) == 1 else jnp.concatenate(es_parts)
        return theta, es
    return theta


def anneal_noisy(problem, a_sched, b_sched, temp, nbr_J_sched, h_sched,
                 theta, key, mcsteps=1, tf=False):
    """SVMC anneal with per-step couplings (NoisySVMC/NoisySVMCTF; the
    reference's 4-D time-dependent nbs array, svmc.pyx:255-264)."""
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    if mcsteps > 1:
        nbr_J_sched = jnp.repeat(nbr_J_sched, mcsteps, axis=0)
        h_sched = jnp.repeat(h_sched, mcsteps, axis=0)

    if packed_ops.supports_packed(problem):
        return packed_ops.packed_noisy_svmc_scan(
            problem, a, b, temp, nbr_J_sched, h_sched, theta, key, tf=tf
        )
    return _masked_noisy_svmc_scan(
        problem, a, b, temp, nbr_J_sched, h_sched, theta, key, tf=tf
    )


def random_state(key, nspins, batch=()):
    """Random initial angles uniform in [0, pi]."""
    shape = tuple(batch) + (nspins,)
    return jax.random.uniform(key, shape) * jnp.pi


z_projection = svmc_ops.z_projection
