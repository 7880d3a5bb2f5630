"""Path-integral QMC sweep ops (Martonak–Santoro–Tosatti protocol).

Data-parallel re-design of the reference PIQMC kernels (qmc.pyx:25-609):

  * State layout is slices-major: confs (..., P, N). The Trotter axis is a
    periodic ring (qmc.pyx:126-138); nearest-slice couplings are `jnp.roll`
    on-chip, or `lax.ppermute` when P is sharded over a mesh axis
    (parallel/trotter.py).
  * Non-dissipative local sweeps use a space-time coloring
    (spatial independent sets x Trotter-ring coloring): every phase updates
    ~N*P/num_phases spins simultaneously — the parallel answer to the
    reference's slice-sequential shuffled sweep (qmc.pyx:97-143).
  * Dissipative sweeps (all-to-all in imaginary time, qmc.pyx:269-273) are
    slice-sequential like the reference — spins of one line interact across
    every slice pair, so slices can't be batched into one phase — but each
    slice update is a colored vector phase, and the bath field is one
    (P,) x (P, N) contraction (a matmul for the full sweep).
  * Global spin-line moves (qmc.pyx:405-438) reduce over the Trotter axis
    (J_perp terms cancel for a whole-line flip) and update a full spatial
    color class of lines in parallel.

Energy conventions (qmc.pyx:95-96, 114-143):
    teff   = P * temp
    jperp  = -(teff/2) ln tanh(Gamma / teff)
    dE_local(i,k) = -2 B s (J s + h) + 2 s jperp (s_up + s_down)
    dE_bath(i,k)  = 2 teff sum_{k'!=k} s_k s_k' lut[|k-k'| ring distance - 1]
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models.coloring import ring_coloring
from montecarlosolvers_tpu.ops.metropolis import metropolis_accept, _color_loop
from montecarlosolvers_tpu.schedules import jperp as jperp_of

# Bath rows are arbitrary float32 (the lookup table): a TF32 contraction
# (about three decimal digits) would perturb the bath field, dE and the
# acceptance decisions, so every bath contraction asks for full float32.
BATH_PRECISION = jax.lax.Precision.HIGHEST


def slice_color_masks(slices):
    """(num_ring_colors, P) bool masks for the Trotter ring."""
    colors, n = ring_coloring(slices)
    return np.arange(n)[:, None] == colors[None, :], n


def spacetime_num_phases(num_colors, slices):
    """Phase count m for the combined space-time coloring
    phase(i, k) = (spatial_color(i) + k) mod m.

    Correctness: spatial neighbors at one slice have distinct spatial
    colors, which stay distinct mod m for m >= num_colors; Trotter
    neighbors (k, k+1) of one spin differ by 1 mod m; the ring wrap pair
    (P-1, 0) differs unless m divides P-1. The smallest valid m is 2 for a
    bipartite lattice with even P — a full sweep in 2 phases, half the
    work of the naive (spatial x ring) product coloring.
    """
    m = max(2, num_colors)
    if slices > 1:
        while (slices - 1) % m == 0:
            m += 1
    return m


def bath_matrix(lookuptable, slices):
    """(P, P) bath coupling matrix: M[k, k'] = lut[ring_dist(k, k') - 1],
    zero diagonal. One matvec with the spin line gives the bath field
    (replaces the O(P) inner loop at qmc.pyx:270-273)."""
    lut = jnp.asarray(lookuptable)
    k = jnp.arange(slices)
    # lut is indexed by (k' - k) mod P - 1 in the reference; the table built
    # by schedules.bath_lookuptable is symmetric in ring distance, and the
    # reference's own indexing (qmc.pyx:271) uses (islice+k)%P with k=1..P-1,
    # i.e. directed offset — equivalent for symmetric tables.
    off = (k[None, :] - k[:, None]) % slices
    m = jnp.where(off > 0, lut[jnp.maximum(off - 1, 0)], 0.0)
    return m


def local_sweep(problem, confs, key, temp, gamma, b, num_phases=None):
    """One space-time colored local sweep (non-dissipative).

    Uses the combined coloring phase(i, k) = (spatial_color(i) + k) mod m
    (see spacetime_num_phases) — 2 phases for the bipartite-lattice /
    even-P benchmark configs, vs the reference's P sequential slice loops
    (qmc.pyx:97-143).

    confs: (..., P, N) float (+1/-1). Returns updated confs.
    """
    slices = confs.shape[-2]
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    b_coeff = -2.0 * b
    m = num_phases or spacetime_num_phases(problem.num_colors, slices)
    spatial_colors = jnp.argmax(problem.color_masks, axis=0)  # (N,)
    stc = (spatial_colors[None, :] + jnp.arange(slices)[:, None]) % m  # (P,N)
    # Phases partition all sites — one uniform draw serves the whole sweep.
    u = jax.random.uniform(key, confs.shape)

    def phase(p, confs):
        field = problem.local_fields(confs)  # (..., P, N)
        s_up = jnp.roll(confs, 1, axis=-2)
        s_dn = jnp.roll(confs, -1, axis=-2)
        de = b_coeff * confs * field + 2.0 * confs * jp * (s_up + s_dn)
        accept = metropolis_accept(de, teff, u) & (stc == p)
        return jnp.where(accept, -confs, confs)

    return _color_loop(m, phase, confs)


def dissipative_local_sweep(problem, confs, key, temp, gamma, b, bath_mat):
    """Slice-sequential colored sweep with system-bath term (qmc.pyx:149-278).

    Slices are visited in order 0..P-1 (matching the reference's slice loop,
    qmc.pyx:99); within a slice each spatial color class updates in parallel.
    """
    slices = confs.shape[-2]
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    b_coeff = -2.0 * b
    # spatial colors partition each slice: one uniform plane per slice
    u = jax.random.uniform(key, confs.shape)

    def slice_body(k, confs):
        s_k = jax.lax.dynamic_index_in_dim(confs, k, axis=-2, keepdims=False)
        s_up = jax.lax.dynamic_index_in_dim(
            confs, (k - 1) % slices, axis=-2, keepdims=False
        )
        s_dn = jax.lax.dynamic_index_in_dim(
            confs, (k + 1) % slices, axis=-2, keepdims=False
        )
        # Bath field for slice k: row k of the bath matrix against all slices.
        row = jax.lax.dynamic_index_in_dim(bath_mat, k, axis=0, keepdims=False)
        bath_field = jnp.einsum("p,...pn->...n", row, confs,
                                precision=BATH_PRECISION)
        u_k = jax.lax.dynamic_index_in_dim(u, k, axis=-2, keepdims=False)

        def phase(c, s_k):
            field = problem.local_fields(s_k)
            de = (
                b_coeff * s_k * field
                + 2.0 * s_k * jp * (s_up + s_dn)
                + 2.0 * teff * s_k * bath_field
            )
            accept = metropolis_accept(de, teff, u_k) & problem.color_masks[c]
            return jnp.where(accept, -s_k, s_k)

        s_k = _color_loop(problem.num_colors, phase, s_k)
        return jax.lax.dynamic_update_index_in_dim(confs, s_k, k, axis=-2)

    return jax.lax.fori_loop(0, slices, slice_body, confs)


def dissipative_colored_sweep(problem, confs, key, temp, gamma, b, bath_mat):
    """Space-time colored sweep with a per-phase bath-field snapshot — the
    fast, approximate form of dissipative_local_sweep.

    The bath couples every slice pair of a line, so an exact parallel
    update needs P sequential phases (dissipative_local_sweep). This
    variant instead updates the usual space-time color classes (m phases,
    like local_sweep) against a bath field recomputed from the full state
    at each phase start: bath-coupled sites within one phase see each
    other's pre-phase values. Same tolerated-asynchrony class as the
    reference's own prange races (SURVEY.md §5) and the cross-device bath
    snapshot in parallel/trotter.py — measured bias on the exactly
    enumerable 2x2/P=2 system: TV(stationary, exact extended Gibbs)
    0.010 at alpha=0.05 (the sampling-noise floor) and 0.018 at
    alpha=0.5. Select via qmc.anneal(bath_update="colored").
    """
    slices = confs.shape[-2]
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    b_coeff = -2.0 * b
    m = spacetime_num_phases(problem.num_colors, slices)
    spatial_colors = jnp.argmax(problem.color_masks, axis=0)
    stc = (spatial_colors[None, :] + jnp.arange(slices)[:, None]) % m
    u = jax.random.uniform(key, confs.shape)

    def phase(p, confs):
        field = problem.local_fields(confs)
        s_up = jnp.roll(confs, 1, axis=-2)
        s_dn = jnp.roll(confs, -1, axis=-2)
        bath = jnp.einsum("kp,...pn->...kn", bath_mat, confs,
                          precision=BATH_PRECISION)
        de = (
            b_coeff * confs * field
            + 2.0 * confs * jp * (s_up + s_dn)
            + 2.0 * teff * confs * bath
        )
        accept = metropolis_accept(de, teff, u) & (stc == p)
        return jnp.where(accept, -confs, confs)

    return _color_loop(m, phase, confs)


def global_line_moves(problem, confs, key, temp, b):
    """Whole-line (all-slices) spin flips (qmc.pyx:405-438).

    dE sums only intra-slice terms over all slices — the J_perp chain terms
    cancel for a full-line flip (qmc.pyx:415-431). One phase per spatial
    color class; all lines of a class flip-test in parallel.
    """
    slices = confs.shape[-2]
    teff = temp * slices
    b_coeff = -2.0 * b
    u = jax.random.uniform(key, confs.shape[:-2] + confs.shape[-1:])

    def phase(c, confs):
        field = problem.local_fields(confs)  # (..., P, N)
        de = jnp.sum(b_coeff * confs * field, axis=-2)  # (..., N)
        accept = metropolis_accept(de, teff, u) & problem.color_masks[c]
        return jnp.where(accept[..., None, :], -confs, confs)

    return _color_loop(problem.num_colors, phase, confs)
