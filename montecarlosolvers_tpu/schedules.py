"""Annealing schedules and derived Trotter/bath coefficient transforms.

Schedules-as-arrays is the reference's config API (examples/santoro80.py:260,
281-284) and is load-bearing here too: each anneal is one `lax.scan` whose
scanned axis IS the schedule.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def linear(start, stop, num):
    """Linear schedule, e.g. T: 3.0 -> 0 (examples/santoro80.py:260)."""
    return jnp.linspace(start, stop, num)


def geometric(start, stop, num):
    return jnp.geomspace(start, stop, num)


def transverse_field(start=3.0, stop=1e-8, num=1000):
    """Gamma schedule; stop defaults to 1e-8 to keep log(tanh(G/PT)) finite
    (examples/santoro80.py:274)."""
    return jnp.linspace(start, stop, num)


def pre_anneal_schedule(start_temp, end_temp, dstep=0.05):
    """The reference's pre-annealing temperature ladder
    (examples/santoro80.py:284): start -> end in steps of `dstep`."""
    n = int((start_temp - end_temp) / dstep) + 1
    return jnp.linspace(start_temp, end_temp, n)


def jperp(gamma, teff):
    """Trotter inter-slice coupling J_perp = -(T_eff/2) ln tanh(Gamma/T_eff)
    (qmc.pyx:95); T_eff = P * T (qmc.pyx:85)."""
    return -0.5 * teff * jnp.log(jnp.tanh(gamma / teff))


def bath_lookuptable(slices, alpha):
    """System-bath coupling strengths vs imaginary-time distance.

    Table of alpha * (pi / (P sin(pi d / P)))^2 for d = 1..P-1, per the
    dissipative Hamiltonian documented at qmc.pyx:162-163. The kernels only
    consume the table (qmc.pyx:270-273); this builder is the caller-side
    companion the reference leaves to the user.
    """
    d = np.arange(1, slices)
    return jnp.asarray(alpha * (np.pi / (slices * np.sin(np.pi * d / slices))) ** 2)


def expand_mcsteps(sched, mcsteps):
    """Repeat each schedule point `mcsteps` times so the scan axis is one
    sweep per element (the reference nests sweeps inside each schedule step,
    sa.pyx:66-69)."""
    if mcsteps == 1:
        return jnp.asarray(sched)
    return jnp.repeat(jnp.asarray(sched), mcsteps)


def segments(num_steps, segment):
    """[(lo, hi), ...] slicing a `num_steps`-long schedule into dispatches
    of at most `segment` steps (tail segment may be shorter; at most two
    distinct lengths, so at most two compiled programs per engine).

    The solvers slice very long schedules at the host level and fold the
    PRNG key per segment, so each device dispatch is bounded in length
    and ships only its own schedule window (utils/checkpoint.py snapshots
    between segments in the same way); `segment=None` disables slicing. A schedule
    that fits one segment is returned as [(0, num_steps)] and the caller
    uses the key unfolded — short anneals stay bitwise-identical to the
    pre-segmentation behavior."""
    if segment is None or num_steps <= segment:
        return [(0, num_steps)]
    return [
        (lo, min(lo + segment, num_steps))
        for lo in range(0, num_steps, segment)
    ]


def pad_schedule(sched, segment, buckets=(32, 4, 1)):
    """Pad a schedule with leading NaN no-op steps so every dispatch shape
    falls in a small compile-bucket set (VERDICT r3 #8: an MST matrix
    rerun compiles <=3 programs per arm instead of one per tau point).

    A NaN temperature/Gamma/B step is an EXACT no-op in every XLA engine:
    it poisons either the step's dE or both Metropolis branches
    (ops/metropolis.metropolis_accept), so the state passes through
    bitwise-unchanged while the PRNG advances. Pads go at the FRONT so
    the real schedule still ends exactly at its final value.

    With the solvers' schedule segmentation (`segments`), full segments
    share one compiled shape and only the tail varies; the tail is padded
    up to the next bucket in {segment/32, segment/4, segment}. The
    padding overhead is at most one bucket of no-op sweeps, against one
    avoided compile per tau point.

    Returns a host-side NumPy array: schedules are built on the host and
    only shipped to the device by the solver (per segment window). A jnp
    return here would round-trip multi-MB schedules device->host->device
    at every `np.asarray(pad_schedule(...))` call site (review r4).
    """
    sched = np.asarray(sched, dtype=np.float32)
    n = len(sched)
    if segment is None:
        return sched
    tail = n % segment or min(n, segment)
    sizes = sorted({max(1, segment // b) for b in buckets})
    padded_tail = next((s for s in sizes if s >= tail), segment)
    pad = padded_tail - tail
    if pad == 0:
        return sched
    return np.concatenate(
        [np.full((pad,), np.nan, dtype=np.float32), sched]
    )
