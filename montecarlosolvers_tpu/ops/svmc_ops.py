"""Spin-vector Monte Carlo sweep ops (classical O(2)-rotor annealing).

Data-parallel re-design of svmc.pyx:21-229: spins are angles theta in [0, pi]; a sweep
proposes new angles and Metropolis-accepts on

    dE = B * sum_j J_ij (cos th' - cos th_i) cos th_j      (z couplings)
       + B * h_i (cos th' - cos th_i)                       (z field)
       + A * (sin th_i - sin th')                           (x field)

(svmc.pyx:96-110). Colored phases replace the shuffled sequential order; the
"Compact" batched-reads variants of the reference (svmc.pyx:455-674) are a
plain vmap/batch axis here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.ops.metropolis import metropolis_accept, _color_loop

PI = jnp.pi


def propose_uniform(u):
    """theta' = pi * u (svmc.pyx:95)."""
    return PI * u


def propose_tf(theta, u, a_coeff, b_coeff):
    """Transverse-field-informed proposal (SVMC-TF, svmc.pyx:198-207):
    a window of width min(1, A/B) * 2*pi around the current angle, clipped
    to [0, pi]."""
    ab_ratio = a_coeff / b_coeff
    width = jnp.minimum(ab_ratio, 1.0)
    prop = theta + width * (2.0 * PI * u - PI)
    return jnp.clip(prop, 0.0, PI)


def _delta_e(problem, theta, theta_prop, a_coeff, b_coeff):
    cos_t = jnp.cos(theta)
    zmagdiff = jnp.cos(theta_prop) - cos_t
    # sum_j J_ij cos th_j + h_i == the problem's linear field applied to the
    # z-projections — works for gather (IsingProblem) and roll
    # (LatticeProblem) backends alike.
    zfield = problem.local_fields(cos_t)
    de = b_coeff * zmagdiff * zfield
    de = de + a_coeff * (jnp.sin(theta) - jnp.sin(theta_prop))
    return de


def svmc_sweep_cached(problem, state, key, temp, a_coeff, b_coeff, tf=False):
    """One colored SVMC sweep on carried trig caches.
    state = (theta, cos theta, sin theta), each (..., N). Carrying the
    projections across phases and sweeps leaves only the proposal's 2
    sin/cos per site per phase (the rotor sweep is transcendental-bound;
    the uncached form pays 4-5)."""
    # One (proposal, acceptance) uniform pair per site per sweep — color
    # phases partition the sites.
    theta0 = state[0]
    ku, ka = jax.random.split(key)
    u_prop = jax.random.uniform(ku, theta0.shape)
    u_acc = jax.random.uniform(ka, theta0.shape)

    def phase(c, state):
        theta, cos_t, sin_t = state
        if tf:
            prop = propose_tf(theta, u_prop, a_coeff, b_coeff)
        else:
            prop = propose_uniform(u_prop)
        cos_p = jnp.cos(prop)
        sin_p = jnp.sin(prop)
        zfield = problem.local_fields(cos_t)
        de = b_coeff * (cos_p - cos_t) * zfield + a_coeff * (sin_t - sin_p)
        accept = metropolis_accept(de, temp, u_acc) & problem.color_masks[c]
        return (
            jnp.where(accept, prop, theta),
            jnp.where(accept, cos_p, cos_t),
            jnp.where(accept, sin_p, sin_t),
        )

    return _color_loop(problem.num_colors, phase, state)


def svmc_sweep(problem, theta, key, temp, a_coeff, b_coeff, tf=False):
    """One colored SVMC sweep. theta: (..., N) float angles in [0, pi].
    Single-sweep convenience form of svmc_sweep_cached (builds and drops
    the trig caches; use the cached form inside scans)."""
    theta, _, _ = svmc_sweep_cached(
        problem, (theta, jnp.cos(theta), jnp.sin(theta)), key, temp,
        a_coeff, b_coeff, tf=tf,
    )
    return theta


def noisy_svmc_sweep_cached(problem, nbr_J_t, h_t, state, key, temp,
                            a_coeff, b_coeff, tf=False):
    """SVMC sweep with per-step couplings (NoisySVMC / NoisySVMCTF,
    svmc.pyx:236-448) on carried trig caches (see svmc_sweep_cached):
    the schedule axis of the 4-D `nbs` array becomes a scanned coupling
    table (nbr_J_t: (N, maxnb), h_t: (N,))."""
    theta0 = state[0]
    ku, ka = jax.random.split(key)
    u_prop = jax.random.uniform(ku, theta0.shape)
    u_acc = jax.random.uniform(ka, theta0.shape)

    def phase(c, state):
        theta, cos_t, sin_t = state
        if tf:
            prop = propose_tf(theta, u_prop, a_coeff, b_coeff)
        else:
            prop = propose_uniform(u_prop)
        cos_p = jnp.cos(prop)
        sin_p = jnp.sin(prop)
        cos_nb = jnp.take(cos_t, problem.nbr_idx, axis=-1)
        zfield = jnp.sum(nbr_J_t * cos_nb, axis=-1) + h_t
        de = b_coeff * (cos_p - cos_t) * zfield + a_coeff * (sin_t - sin_p)
        accept = metropolis_accept(de, temp, u_acc) & problem.color_masks[c]
        return (
            jnp.where(accept, prop, theta),
            jnp.where(accept, cos_p, cos_t),
            jnp.where(accept, sin_p, sin_t),
        )

    return _color_loop(problem.num_colors, phase, state)


def noisy_svmc_sweep(problem, nbr_J_t, h_t, theta, key, temp, a_coeff,
                     b_coeff, tf=False):
    """Single-sweep convenience form of noisy_svmc_sweep_cached."""
    theta, _, _ = noisy_svmc_sweep_cached(
        problem, nbr_J_t, h_t, (theta, jnp.cos(theta), jnp.sin(theta)),
        key, temp, a_coeff, b_coeff, tf=tf,
    )
    return theta


def z_projection_from_cos(cos_theta):
    """z_projection evaluated on an already-computed cos cache (the scan
    carriers hold cos theta; recomputing the cosine would defeat them)."""
    return jnp.where(cos_theta >= 0.0, 1.0, -1.0)


def z_projection(theta):
    """Project rotor angles to Ising spins: sign(cos theta), +1 at the
    boundary — the standard readout for SVMC states."""
    return z_projection_from_cos(jnp.cos(theta))
