"""Cluster updates: Wolff space-time clusters and Swendsen-Wang-style bath
clusters, re-formulated for parallel hardware.

The reference grows clusters with a sequential stack (qmc.pyx:711-786,
907-996, 1114-1221, 1400-1446, 1556-1612) — inherently serial. This
formulation splits each cluster update into data-parallel stages:

  1. Bond draw: every candidate bond of the space-time interaction graph is
     drawn independently with the reference's bond probability
     p = 1 - exp(dE_bond / T_eff) (bonds only between spins equal to the
     seed sign, as in the reference's `confs[..] == k` gate).
  2. Seed component: a boolean frontier BFS grown from the seed over the
     active bond graph inside a `lax.while_loop` — it stops at the seed
     component's eccentricity, not the whole graph's, and carries byte
     masks instead of int32 labels (the round-3 min-label fixed point paid
     the whole-graph cost for every cluster: 137 ms per benchmark-scale
     cluster vs <10 ms for the BFS, VERDICT r3 #1). For the per-spin
     imaginary-time bath graphs of the WC2/WC3 variants (P x P, P <= 64):
     transitive closure by log2(P) squarings of the boolean adjacency,
     batched over spins as matrix products.
  3. Flip the seed's component (Wolff), or Metropolis-accept the whole
     component with its exact set-flip energy (SW-bath variants).

Known deviations from the reference, by design (SURVEY.md §7 "hard parts").
The reference's stack algorithms are *approximate* samplers: the WCL bond
rule folds the field bias into bond probabilities and damps them with a
cumulative r *= p (qmc.pyx:723-736), ignores satisfied antiferromagnetic
bonds, and flips with probability 1 — none of which satisfies detailed
balance; the whole section is marked "function under test" (qmc.pyx:612-614).
We instead implement the provably-correct cluster algorithms for the same
Hamiltonians and validate them against exact extended-Gibbs distributions
(tests/test_cluster_exact.py):

  * rule="local" (WCL family) is true satisfied-bond Fortuin-Kasteleyn:
    every pair interaction (spatial B J_ij, Trotter -jperp, bath
    -T_eff lut[d-1]) contributes a bond with p = 1 - exp(2 K s_i s_j /
    T_eff) when satisfied (K s_i s_j < 0) — including antiferromagnetic
    bonds between opposite-sign spins, which the reference drops. The
    seed's component (mixed signs) flips with a Metropolis accept on the
    *field* term only; with no fields the accept is 1 (textbook Wolff).
    The reference's order-dependent damping factor r has no parallel
    analog and is gone (its own WC variant also comments damping out,
    qmc.pyx:1149,1180,1216).
  * The SW-bath accept (WC2) uses the exact set-flip energy of the
    non-bath terms only — the bath boundary factor is already paid by the
    FK bond draw (including it again, as a naive reading of
    qmc.pyx:1572-1621 does, double-counts the bath). WC2's inverted accept
    (qmc.pyx:1442-1446) and bath-distance slip (qmc.pyx:1368-1371) are
    not replicated. The WC3 analog (`sw_full_phase`) moves the Trotter
    ring into the FK draw as well, so ALL clusters of a line flip
    independently on the (linear) field term in one phase — full
    Swendsen-Wang instead of P sequential per-seed Wolff phases.
  * rule="full" (WC, qmc.pyx:1006-1225) keeps the reference's
    full-local-energy bond-rule *heuristic* (bond probabilities from the
    candidate's single-flip dE, seed-sign gating, flip prob 1). It is not
    a detailed-balance sampler there or here; kept for API parity and
    validated structurally only.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.schedules import jperp as jperp_of
from montecarlosolvers_tpu.ops.metropolis import metropolis_accept


def _bond_prob(de, teff):
    """p = 1 - exp(dE/T_eff) for dE < 0, else 0 (qmc.pyx:727-728)."""
    return jnp.where(de < 0.0, 1.0 - jnp.exp(de / teff), 0.0)


def _mirror_upper(u):
    """Symmetrize per-pair uniforms over the last two axes by mirroring the
    upper triangle — each undirected pair gets exactly ONE draw (taking a
    min would inflate the bond probability to 1-(1-p)^2)."""
    n = u.shape[-1]
    r = jnp.arange(n)
    upper = r[:, None] < r[None, :]
    return jnp.where(upper, u, jnp.swapaxes(u, -1, -2))


# --------------------------------------------------------------------------
# Full space-time Wolff cluster (QuantumAnnealWCL / QuantumAnnealWC)
# --------------------------------------------------------------------------

def _symmetrize_spatial(active_sp, nbr_idx):
    """Make the directed spatial-bond mask undirected, safely under
    duplicate neighbor slots.

    active_sp[k, i, m] marks the bond between i and j = nbr_idx[i, m] as
    drawn-active in i's row. wolff_update draws each undirected pair once
    (from the lower-index endpoint), so the BFS needs the activation
    visible from BOTH endpoints. Neighbor tables may also store the same
    (i, j) pair in several slots of one row — generate_neighbors does this
    for inputs carrying both (i, j) and (j, i), e.g. a dense symmetric J —
    so the reverse gather must not key on a single back-slot: first OR the
    activations across a row's duplicate slots, then gather any one
    back-slot of j's row (all of j's slots pointing at i now agree).

    Returns active_full with the same shape: bond (i <-> j) active iff any
    slot of either endpoint's row drew it.
    """
    slices = active_sp.shape[0]
    nspins, maxnb = nbr_idx.shape
    r = jnp.arange(nspins, dtype=nbr_idx.dtype)
    # OR across duplicate slots within each row (maxnb is tiny, so the
    # (N, maxnb, maxnb) mask is cheap). Pad slots point at self and are
    # never active, so OR-ing them is harmless.
    same_nb = nbr_idx[:, :, None] == nbr_idx[:, None, :]  # (N, maxnb, maxnb)
    active_or = jnp.any(active_sp[:, :, None, :] & same_nb[None], axis=-1)
    # rev_slot[i, m] = any slot of j's row that points back at i.
    back = jnp.take(nbr_idx, nbr_idx, axis=0)  # (N, maxnb, maxnb)
    rev_slot = jnp.argmax(back == r[:, None, None], axis=-1)  # (N, maxnb)
    flat_idx = (nbr_idx * maxnb + rev_slot).reshape(-1)  # (N*maxnb,)
    active_rev = (
        active_or.reshape(slices, -1)[:, flat_idx].reshape(active_sp.shape)
    )
    return active_or | active_rev


def _seed_component(seed_slice, seed_spin, active_sp, nbr_idx, active_up,
                    active_bath=None):
    """Boolean frontier BFS from the seed over the active bond graph.

    The reference grows exactly the seed's component with an O(cluster
    size) stack (qmc.pyx:711-786); the round-3 min-label fixed point
    instead relaxed ALL (P, N) labels to convergence — paying the whole
    graph's diameter for every cluster (137 ms at P=40, N=6400, VERDICT r3
    #1). The BFS carries two byte masks and stops the `while_loop` the
    moment the frontier empties, i.e. at the seed component's eccentricity.

    active_sp: (P, N, maxnb) bool — spatial bonds, directed (one draw per
      undirected pair); symmetrized here.
    active_up: (P, N) bool — temporal bond between slice k and k+1 (mod P).
    active_bath: optional (N, P, P) bool, symmetric in the slice axes —
      all-distance imaginary-time bath bonds (dissipative WCL,
      qmc.pyx:907-927).

    Returns (P, N) bool — the seed's connected component.
    vmap-compatible: under a chain batch the loop runs until every chain's
    frontier is empty (cost = max eccentricity over the batch).
    """
    slices, nspins = active_up.shape
    active_full = _symmetrize_spatial(active_sp, nbr_idx)
    dn_active = jnp.roll(active_up, 1, axis=0)

    seed = jnp.zeros((slices, nspins), bool)
    seed = seed.at[seed_slice, seed_spin].set(True)

    def cond(state):
        _, frontier = state
        return jnp.any(frontier)

    def body(state):
        visited, frontier = state
        nb_f = jnp.take(frontier, nbr_idx, axis=1)  # (P, N, maxnb)
        reach = jnp.any(nb_f & active_full, axis=-1)
        # Temporal ring: bond active_up[k] joins slices k and k+1.
        reach |= active_up & jnp.roll(frontier, -1, axis=0)
        reach |= dn_active & jnp.roll(frontier, 1, axis=0)
        if active_bath is not None:
            f_t = frontier.T  # (N, P)
            reach |= jnp.any(active_bath & f_t[:, None, :], axis=-1).T
        new_frontier = reach & ~visited
        return visited | new_frontier, new_frontier

    visited, _ = jax.lax.while_loop(cond, body, (seed, seed))
    return visited


def wolff_update(problem, confs, key, temp, gamma, b, rule="local",
                 lookuptable=None):
    """One Wolff cluster update on an unbatched (P, N) configuration.

    rule="local" (QuantumAnnealWCL / DissaptiveQuantumAnnealWCL,
      qmc.pyx:620-1000, corrected — module docstring): exact satisfied-bond
      FK. Every pair interaction contributes a bond with
      p = 1 - exp(2 K s_i s_j / T_eff) when K s_i s_j < 0:
      spatial K = B J_ij, temporal K = -jperp, bath K = -T_eff lut[d-1]
      (lookuptable, all slice distances of one spin line). The seed's
      component flips with a Metropolis accept on the field term
      (accept = 1 when h = 0).

      Scale limit (bath path): the bath bond draw materializes (N, P, P)
      dE/uniform/active tensors — 41 MB each at N=6400, P=40, with ~3 live
      at once per chain. Benchmark scale fits one chain comfortably in
      16 GB HBM; keep chains * N * P^2 * 4 B under a few GB (e.g. <= 8
      chains at N=6400, P=40) or shard chains across chips.
    rule="full": the reference's full-local-energy bond-rule heuristic
      (QuantumAnnealWC, qmc.pyx:1124-1221): bond prob from the candidate's
      single-flip dE, seed-sign-gated, flip prob 1. Not detailed-balanced.

    vmap over a leading chain axis for batched states.
    """
    slices, nspins = confs.shape
    teff = temp * slices
    jp = jperp_of(gamma, teff)

    k_seed_key, k_sp, k_t, k_site, k_bath, k_acc = jax.random.split(key, 6)
    seed_spin = jax.random.randint(k_seed_key, (), 0, nspins)
    seed_slice = jax.random.randint(k_site, (), 0, slices)

    s = confs.astype(jnp.float32)
    pad = problem.nbr_idx == jnp.arange(nspins)[:, None]  # self slots
    s_nb = jnp.take(s, problem.nbr_idx, axis=1)  # (P, N, maxnb)

    if rule == "local":
        # pair-energy bonds on the actual spin products: satisfied bonds
        # (dE < 0) of either sign relation can activate. Each undirected
        # pair appears in BOTH endpoints' neighbor slots; draw it exactly
        # once, from the lower-index endpoint (_seed_component symmetrizes
        # the mask, so one directed activation connects both ends) — a double
        # draw would inflate the bond probability to 1-(1-p)^2.
        de_sp = 2.0 * b * problem.nbr_J[None] * s[:, :, None] * s_nb
        de_t = -2.0 * jp * s * jnp.roll(s, -1, axis=0)
        lower = jnp.arange(nspins)[:, None] < problem.nbr_idx  # excludes pad
        gate_sp = lower[None, :, :]
        gate_t = True
    else:
        # Candidate j at slice t: its full single-flip dE on the current
        # config, sign fixed to the seed sign k; only seed-sign spins may
        # join (qmc.pyx:1124-1148).
        kval = confs[seed_slice, seed_spin]
        same = confs == kval
        field = problem.local_fields(s)  # (P, N)
        up = jnp.roll(s, 1, axis=0)
        dn = jnp.roll(s, -1, axis=0)
        de_site = -2.0 * b * kval * field + 2.0 * jp * kval * (up + dn)  # (P, N)
        de_sp = jnp.take(de_site, problem.nbr_idx, axis=1)  # (P, N, maxnb)
        # temporal candidate is the same spin at the adjacent slice
        de_t = jnp.roll(de_site, -1, axis=0)
        nb_same = jnp.take(same, problem.nbr_idx, axis=1)
        gate_sp = same[:, :, None] & nb_same & (~pad)[None, :, :]
        gate_t = same & jnp.roll(same, -1, axis=0)

    u_sp = jax.random.uniform(k_sp, de_sp.shape)
    u_t = jax.random.uniform(k_t, de_t.shape)
    active_sp = gate_sp & (u_sp < _bond_prob(de_sp, teff))
    active_up = gate_t & (u_t < _bond_prob(de_t, teff))

    active_bath = None
    if lookuptable is not None:
        lut = jnp.asarray(lookuptable)
        off = (jnp.arange(slices)[None, :] - jnp.arange(slices)[:, None]) % slices
        st = s.T  # (N, P)
        de_b = (
            -2.0 * teff * lut[jnp.maximum(off - 1, 0)][None]
            * st[:, :, None] * st[:, None, :]
        )  # (N, P, P)
        p_b = jnp.where(off[None] > 0, _bond_prob(de_b, teff), 0.0)
        u_b = jax.random.uniform(k_bath, (nspins, slices, slices))
        u_b = _mirror_upper(u_b)  # one draw per undirected pair
        active_bath = u_b < p_b
        if rule != "local":
            same_t = same.T
            active_bath = active_bath & same_t[:, :, None] & same_t[:, None, :]

    comp = _seed_component(
        seed_slice, seed_spin, active_sp, problem.nbr_idx, active_up,
        active_bath,
    )

    if rule == "local":
        # Metropolis accept on the field term — the only interaction not
        # represented by bonds (standard Wolff-in-a-field correction)
        de_h = -2.0 * b * jnp.sum(problem.h[None, :] * s, axis=(0, 1), where=comp)
        accept = metropolis_accept(de_h, teff, jax.random.uniform(k_acc, ()))
        flip = comp & accept
    else:
        flip = comp & same
    return jnp.where(flip, -confs, confs)


# --------------------------------------------------------------------------
# Bath-bond imaginary-time clusters (WC2 / WC3 family)
# --------------------------------------------------------------------------

def _time_closure(adj):
    """Transitive closure of (..., P, P) boolean adjacency by repeated
    squaring (log2(P) matmuls)."""
    P = adj.shape[-1]
    a = adj.astype(jnp.float32) + jnp.eye(P, dtype=jnp.float32)
    n_iter = max(1, int(np.ceil(np.log2(max(P, 2)))))
    # operands are 0/1 with float32 accumulation: exact at DEFAULT
    # precision (TF32 included), so no precision is pinned here
    for _ in range(n_iter):
        a = jnp.minimum(
            jnp.einsum("...ij,...jk->...ik", a, a, preferred_element_type=jnp.float32),
            1.0,
        )
    return a > 0.0


def _line_set_flip_de(problem, confs, spin_field, flip_mask, b, jp):
    """Energy change of flipping the slice-set `flip_mask` of every spin
    line simultaneously, over the NON-bath terms (evaluated per spin;
    neighbors held fixed). The bath term is deliberately absent: in the
    SW-bath move it is accounted for by the FK bond draw, and including it
    in the accept would double-count it (module docstring).

    confs: (P, N); spin_field: (P, N) intra-slice fields (J s + h);
    flip_mask: (P, N) bool. Returns (N,) dE per line.
    """
    s = confs.astype(jnp.float32)
    t = jnp.where(flip_mask, -s, s)
    # Linear (intra-slice) part: E_lin = B sum_k field_k s_k per line.
    de = b * jnp.sum(spin_field * (t - s), axis=0)
    # Trotter ring: E_trot = -jperp sum_k s_k s_{k+1}.
    de = de - jp * jnp.sum(
        t * jnp.roll(t, -1, axis=0) - s * jnp.roll(s, -1, axis=0), axis=0
    )
    return de


def bath_cluster_phase(problem, confs, key, temp, gamma, b, lookuptable,
                       seed_slices, color_mask):
    """One parallel phase of SW-style bath-bond cluster moves.

    For every spin in `color_mask`, grow a cluster along imaginary time
    using only satisfied bath bonds with p = 1 - exp(-2 lut[d-1])
    (qmc.pyx:1400-1405; bath couplings are ferromagnetic so satisfied =
    same-sign), then Metropolis-accept the whole cluster with the exact
    set-flip energy of the non-bath terms (WC3 rule, qmc.pyx:1617-1621,
    corrected — the bath part is already paid by the bond draw). This is
    the standard partial-interaction-embedded Wolff construction and is
    exactly detailed-balanced (tests/test_cluster_exact.py).

    confs: (P, N). seed_slices: (N,) int32 seed slice per spin.
    """
    slices, nspins = confs.shape
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    lut = jnp.asarray(lookuptable)

    k_bond, k_acc = jax.random.split(key)

    # Bond probabilities by ring distance (symmetric, distance-only).
    off = (jnp.arange(slices)[None, :] - jnp.arange(slices)[:, None]) % slices
    p_pair = jnp.where(off > 0, 1.0 - jnp.exp(-2.0 * lut[jnp.maximum(off - 1, 0)]), 0.0)

    kval = jnp.take_along_axis(confs, seed_slices[None, :], axis=0)[0]  # (N,)
    same = confs == kval[None, :]  # (P, N)

    u = jax.random.uniform(k_bond, (nspins, slices, slices))
    u = _mirror_upper(u)  # one draw per undirected pair
    adj = (u < p_pair[None, :, :]) & same.T[:, :, None] & same.T[:, None, :]

    closure = _time_closure(adj)  # (N, P, P)
    seed_onehot = jax.nn.one_hot(seed_slices, slices, dtype=jnp.bool_)  # (N, P)
    comp = jnp.einsum("npq,np->nq", closure.astype(jnp.float32),
                      seed_onehot.astype(jnp.float32),
                      precision=jax.lax.Precision.HIGHEST) > 0.0  # (N, P)
    comp = comp.T & same  # (P, N)

    field = problem.local_fields(confs.astype(jnp.float32))
    de = _line_set_flip_de(problem, confs, field, comp & color_mask[None, :],
                           b, jp)
    u_acc = jax.random.uniform(k_acc, (nspins,))
    accept = metropolis_accept(de, teff, u_acc) & color_mask
    return jnp.where(comp & accept[None, :], -confs, confs)


def sw_full_phase(problem, confs, key, temp, gamma, b, lookuptable,
                  color_mask):
    """One parallel phase of FULL Swendsen-Wang line decomposition: every
    cluster of every active-color spin line is updated in one shot.

    Both imaginary-time interactions of a spin line — the all-distance bath
    couplings -T_eff lut[d-1] s_k s_q AND the Trotter ring -jperp s_k s_{k+1}
    — join the FK bond draw (both are ferromagnetic, p = 1 - exp(-2K/T_eff)
    on satisfied pairs). Conditioned on the bonds, the line's remaining
    energy is the intra-slice field term B sum_k field_k s_k, which is
    LINEAR in the line's spins: per-cluster flip energies add, so every
    cluster Metropolis-accepts INDEPENDENTLY with its own field dE — the
    textbook partial-interaction Swendsen-Wang step, exactly
    detailed-balanced (tests/test_cluster_exact.py).

    This replaces the round-3 per-seed formulation of WC3, which ran
    P x colors sequential Wolff phases, each paying a full (N, P, P)
    bond-draw + closure for ONE seed slice per line (VERDICT r3 #4). One
    SW phase updates all P slices of a
    line for the cost of one closure; a sweep is `colors` phases total.

    Cluster consistency: reachability rows of `_time_closure` are identical
    for slices in the same component, so the per-slice field dE (a closure
    matvec) agrees across a cluster, and the accept uniform is shared by
    indexing each slice's FIRST cluster member (argmax of its closure row).

    confs: (P, N). color_mask: (N,) bool — spins whose lines may flip this
    phase (spatial neighbors stay frozen, as in every colored phase).
    """
    slices, nspins = confs.shape
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    lut = jnp.asarray(lookuptable)

    k_bath, k_t, k_acc = jax.random.split(key, 3)

    # Bath FK bonds: satisfied = equal-sign pair (couplings ferromagnetic).
    off = (jnp.arange(slices)[None, :] - jnp.arange(slices)[:, None]) % slices
    p_pair = jnp.where(
        off > 0, 1.0 - jnp.exp(-2.0 * lut[jnp.maximum(off - 1, 0)]), 0.0
    )
    st = confs.T  # (N, P)
    eq = st[:, :, None] == st[:, None, :]  # (N, P, P) equal-sign pairs
    u = _mirror_upper(jax.random.uniform(k_bath, (nspins, slices, slices)))
    adj = (u < p_pair[None]) & eq

    # Trotter ring FK bonds: edge k <-> k+1 (mod P), one draw per k — for
    # P=2 the ring doubles the (0,1) coupling and the two parallel edges
    # correctly union to 1-(1-p)^2, matching wolff_update's convention.
    p_t = 1.0 - jnp.exp(-2.0 * jp / teff)
    u_t = jax.random.uniform(k_t, (slices, nspins))
    active_t = (confs == jnp.roll(confs, -1, axis=0)) & (u_t < p_t)  # (P, N)
    ring = jnp.zeros((slices, slices), bool).at[
        jnp.arange(slices), (jnp.arange(slices) + 1) % slices
    ].set(True)
    adj = adj | (ring[None] & active_t.T[:, :, None])
    adj = adj | jnp.swapaxes(adj, -1, -2)

    closure = _time_closure(adj)  # (N, P, P): row k = k's cluster
    cl = closure.astype(jnp.float32)

    # Per-cluster field dE, broadcast to every member slice.
    s = confs.astype(jnp.float32)
    field = problem.local_fields(s)  # (P, N)
    site_de = -2.0 * b * field * s  # dE of flipping one site (field term)
    de = jnp.einsum("nkj,jn->kn", cl, site_de,
                    precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)  # (P, N)

    # One uniform per CLUSTER: index each slice's first cluster member.
    rep = jnp.argmax(closure, axis=-1)  # (N, P) min member index
    u_acc = jax.random.uniform(k_acc, (slices, nspins))
    u_sel = jnp.take_along_axis(u_acc.T, rep, axis=1).T  # (P, N)

    accept = metropolis_accept(de, teff, u_sel) & color_mask[None, :]
    return jnp.where(accept, -confs, confs)


def sw_bath_sweep(problem, confs, key, temp, gamma, b, lookuptable,
                  per_slice_seeds=False):
    """Full SW-bath cluster sweep over all spins.

    per_slice_seeds=False: one random seed slice per spin, one Wolff-style
    cluster flip per line (WC2 outer loop, qmc.pyx:1390-1398).
    per_slice_seeds=True: the reference's WC3 seeds every slice in turn
    (qmc.pyx:1546); here one full Swendsen-Wang decomposition updates
    every cluster of every line per phase (`sw_full_phase`) — strictly
    more ergodic work than P sequential seeds, at 1/P the cost.
    Spins are processed per spatial color class so concurrent line flips
    never share an interaction.
    """
    slices, nspins = confs.shape
    colors = problem.num_colors
    if per_slice_seeds:
        def phase(c, carry):
            confs, key = carry
            key, sub = jax.random.split(key)
            confs = sw_full_phase(
                problem, confs, sub, temp, gamma, b, lookuptable,
                problem.color_masks[c],
            )
            return confs, key

        confs, _ = jax.lax.fori_loop(0, colors, phase, (confs, key))
    else:
        key, kseed = jax.random.split(key)
        seeds = jax.random.randint(kseed, (nspins,), 0, slices)

        def phase(c, carry):
            confs, key = carry
            key, sub = jax.random.split(key)
            confs = bath_cluster_phase(
                problem, confs, sub, temp, gamma, b, lookuptable,
                seeds, problem.color_masks[c],
            )
            return confs, key

        confs, _ = jax.lax.fori_loop(0, colors, phase, (confs, key))
    return confs


# --------------------------------------------------------------------------
# Classical Swendsen-Wang (beyond reference: qmc.pyx clusters are PIQMC-only)
# --------------------------------------------------------------------------

def _label_components(active_full, nbr_idx, init=None, jump_every=0):
    """Connected-component labels of the active spatial bond graph.

    Min-label relaxation: each round pulls the minimum neighbor label
    across active bonds until the fixed point (each component's minimum
    index), one round per hop of the largest component's eccentricity —
    the same cost model as the Wolff frontier BFS, but labeling EVERY
    component in the one pass.

    jump_every=0 (the SW/Wolff default): pure relaxation, no pointer
    jumping — `labels[labels]` is a 1-D dynamic gather over the whole
    label array, where a relax round is one static-shape neighbor-table
    gather; FK draws produce small component diameters.

    jump_every=k>0: k relax rounds then two pointer jumps per while
    iteration — Shiloach-Vishkin-style shortcutting that converges in
    O(k + log diameter) iterations instead of O(diameter) rounds. The
    option exists for exotic graphs (diameter >> 1000); no in-repo
    caller uses it, and its cost against plain relaxation has not been
    measured on the GPU. Regular-grid problems should use
    _label_components_grid instead (rolls; 23 -> 5.4 ms/phase measured).
    Exact either way: labels only decrease, always point into their own
    component, and any relax-stable labeling is constant per component,
    so the fixed point is unchanged.

    active_full: (N, maxnb) bool, symmetrized; returns (N,) int32.
    init: optional (N,) int32 starting labels (default arange). Seeding
      sites with -1 marks them (and, after relaxation, their whole
      component) frozen — the ghost-spin field construction rides the
      same relax loop instead of a separate scatter-by-label; jumps
      preserve the marker (-1 is absorbing under both passes).
    """
    nspins = nbr_idx.shape[0]
    if init is None:
        init = jnp.arange(nspins, dtype=jnp.int32)

    def cond(state):
        labels, changed = state
        return changed

    def _relax(labels):
        nb_lab = jnp.where(active_full, labels[nbr_idx], nspins)
        return jnp.minimum(labels, jnp.min(nb_lab, axis=-1))

    def body(state):
        labels, _ = state
        new = _relax(labels)
        return new, jnp.any(new != labels)

    def body_jump(state):
        labels, _ = state
        new = labels
        for _ in range(jump_every):
            new = _relax(new)
        for _ in range(2):
            # pointer jump; -1 (frozen) is absorbing: a frozen site stays
            # frozen, a site pointing at a frozen one becomes frozen
            new = jnp.where(new < 0, -1, new[jnp.maximum(new, 0)])
        new = _relax(new)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(
        cond, body_jump if jump_every else body, (init, jnp.bool_(True))
    )
    return labels


def classical_sw_sweep(problem, s, key, temp):
    """One classical Swendsen-Wang sweep: FK bond draw on satisfied pairs,
    component labeling, every cluster flipped with probability 1/2.

    Fields use the ghost-spin construction: a satisfied field term
    (h_i s_i < 0) bonds site i to a fixed ghost spin with
    p = 1 - exp(2 h_i s_i / T). All ghost-attached components form one
    cluster with the ghost; in the gauge s_ghost = +1 that cluster never
    flips, and every free cluster flips with an independent fair coin —
    exact Gibbs sampling of H = sum J s s + sum h s (histogram-tested).

    s: (N,) float +/-1 (vmap over leading axes for chains).
    Cost (generic path): one (N, maxnb) bond draw + one min-label relax
    round per hop of the largest component's eccentricity — about the
    price of ONE Wolff cluster's frontier BFS, but every cluster in the
    lattice updates. LatticeProblems route to classical_sw_sweep_lattice
    (segmented row/column min-scans) when passed here directly;
    solvers/sa.anneal_sw converts lattices to the generic form instead
    (see that docstring).
    """
    if hasattr(problem, "j_right"):
        return classical_sw_sweep_lattice(problem, s, key, temp)
    nspins = problem.nspins
    k_sp, k_h, k_coin = jax.random.split(key, 3)

    s_nb = jnp.take(s, problem.nbr_idx, axis=0)  # (N, maxnb)
    de_sp = 2.0 * problem.nbr_J * s[:, None] * s_nb
    lower = jnp.arange(nspins)[:, None] < problem.nbr_idx  # one draw/pair
    u_sp = jax.random.uniform(k_sp, de_sp.shape)
    active_sp = lower & (u_sp < _bond_prob(de_sp, temp))
    active_full = _symmetrize_spatial(
        active_sp[None], problem.nbr_idx)[0]  # (N, maxnb)

    # ghost bonds: satisfied field terms freeze their whole component.
    # Seeding ghosted sites with label -1 lets the min-relax itself carry
    # the freeze to every member (no scatter-by-label needed).
    de_h = 2.0 * problem.h * s
    u_h = jax.random.uniform(k_h, (nspins,))
    ghosted = u_h < _bond_prob(de_h, temp)
    init = jnp.where(ghosted, -1, jnp.arange(nspins, dtype=jnp.int32))
    labels = _label_components(active_full, problem.nbr_idx, init)

    coins = jax.random.bernoulli(k_coin, 0.5, (nspins,))
    flip = (labels >= 0) & coins[jnp.maximum(labels, 0)]
    return jnp.where(flip, -s, s)


def grid_bonds_from_edges(shape, rows, cols, vals):
    """Per-axis bond masks for a k-D grid instance, host-side.

    For a problem whose sites are a C-order raveled `shape` grid and
    whose every edge connects x to x+1 (mod L_a) along exactly one axis
    a (open or periodic — e.g. models/instances.random_2d_lattice /
    random_3d_lattice), returns a tuple of k bool arrays, one per axis,
    where mask_a[x] = True iff the bond (x, x+e_a) exists with a nonzero
    coupling. This is the static input of houdayer_sweep_grid /
    _label_components_grid — the roll-based labeler that replaces the
    (N, maxnb) gather relax with shifts of the whole grid.

    Raises ValueError on any edge that is not a unit grid step (fields,
    i.e. rows == cols diagonal entries, are ignored — Houdayer moves are
    field-agnostic: the flip is isoenergetic for the pair regardless).
    """
    shape = tuple(int(s) for s in shape)
    masks = [np.zeros(shape, dtype=bool) for _ in shape]
    for a, b, v in zip(np.asarray(rows), np.asarray(cols), np.asarray(vals)):
        if a == b or v == 0.0:
            continue
        ia = np.unravel_index(int(a), shape)
        ib = np.unravel_index(int(b), shape)
        hit = None
        for ax in range(len(shape)):
            d = (ib[ax] - ia[ax]) % shape[ax]
            if d == 0:
                continue
            rest_equal = all(
                ia[o] == ib[o] for o in range(len(shape)) if o != ax
            )
            if d == 1 and rest_equal:
                hit = (ax, ia)
            elif d == shape[ax] - 1 and rest_equal:
                hit = (ax, ib)
            else:
                hit = None
                break
        if hit is None:
            raise ValueError(f"edge ({a},{b}) is not a unit grid step")
        masks[hit[0]][hit[1]] = True
    return tuple(jnp.asarray(m) for m in masks)


def _label_components_grid(bond_masks, init, rounds_per_check=8):
    """Connected-component labels on a k-D grid bond graph via roll-based
    min-label relaxation — the form of _label_components for regular
    grids: each round is 4k whole-grid rolls + mins instead of an
    (N, maxnb) gather. The percolating overlap domains Houdayer produces
    (q = -1 fraction ~0.5) take 100-160 relax rounds. Plain relaxation
    (no pointer jumping: one batched 1-D dynamic gather per jump) with
    `rounds_per_check` rounds per convergence test.

    bond_masks: tuple over axes of bool grids, mask_a[x] = bond
      (x, x+e_a mod L_a) active. Wrap entries False for open boundaries.
    init: int32 label grid (leading batch axes allowed; axes are counted
      from the trailing len(bond_masks) dims). -1 is absorbing (frozen).
    Returns labels at the fixed point (component minimum, grid-shaped).
    """
    k = len(bond_masks)
    big = jnp.int32(np.prod(bond_masks[0].shape, dtype=np.int64))

    def relax(lab):
        off = lab.ndim - k
        m = lab
        for ax, mask in enumerate(bond_masks):
            axis = off + ax
            fwd = jnp.where(mask, jnp.roll(lab, -1, axis), big)
            bwd = jnp.where(
                jnp.roll(mask, 1, ax), jnp.roll(lab, 1, axis), big
            )
            m = jnp.minimum(m, jnp.minimum(fwd, bwd))
        return m

    def cond(state):
        return state[1]

    def body(state):
        lab, _ = state
        new = lab
        for _ in range(rounds_per_check):
            new = relax(new)
        return new, jnp.any(new != lab)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return labels


def houdayer_sweep_grid(bond_masks, s1, s2, key):
    """Houdayer isoenergetic cluster move on a regular grid — identical
    statistics to houdayer_sweep (same q = -1 domain decomposition, same
    fair coin per component; see its docstring for the exactness
    argument) with the labeling done by _label_components_grid rolls.

    bond_masks: from grid_bonds_from_edges (or LatticeProblem planes).
    s1, s2: (N,) float +/-1, C-order raveled grid (vmap over leading
      axes for rung ladders). Returns (s1', s2', flipped (N,) bool).
    """
    shape = bond_masks[0].shape
    n = s1.shape[-1]
    q_neg = ((s1 * s2) < 0).reshape(shape)
    active = tuple(
        m & q_neg & jnp.roll(q_neg, -1, ax)
        for ax, m in enumerate(bond_masks)
    )
    init = jnp.where(
        q_neg, jnp.arange(n, dtype=jnp.int32).reshape(shape), jnp.int32(n)
    )
    labels = _label_components_grid(active, init).reshape((n,))
    coins = jax.random.bernoulli(key, 0.5, (n + 1,))
    flip = q_neg.reshape((n,)) & jnp.take(coins, jnp.minimum(labels, n))
    return jnp.where(flip, -s1, s1), jnp.where(flip, -s2, s2), flip


def houdayer_sweep(problem, s1, s2, key, jump_every=0):
    """Isoenergetic (Houdayer) cluster move between two replicas sampled
    at the SAME temperature — the replica-cluster update the spin-glass
    literature adopted after ferromagnet-style FK clusters were shown to
    percolate on frustrated instances (bench/cluster_value.py measures
    this for the framework; Houdayer 2001, and the ICM scheme of
    Zhu-Ochoa-Katzgraber 2015 when mixed into parallel tempering).

    Construction: q_i = s1_i * s2_i; the q = -1 domain is cut into
    connected components over the problem's adjacency (bonds are NOT
    probabilistic — any nonzero coupling with both endpoints in the
    domain links them), and every component flips in BOTH replicas with
    an independent fair coin. Each component flip exchanges energy
    between the replicas exactly (every boundary bond and every field
    term satisfies dE1 = -dE2, because q = +1 outside the component and
    s2 = -s1 inside), so the move is rejection-free for the product
    measure at equal temperatures, and it leaves q — hence the component
    structure itself — invariant. This is the full Swendsen-Wang form of
    Houdayer's single-cluster move: flips of distinct components are
    independent (components are never adjacent through q = -1 sites), so
    coin-flipping all of them at once is also exact, updates every
    domain for one labeling, and reuses the same min-label relax as the
    classical SW engine.

    problem: generic IsingProblem (LatticeProblems: convert via
      to_generic, as solvers.sa.anneal_sw does).
    s1, s2: (N,) float +/-1 — vmap over leading axes for rung ladders.
    jump_every: pointer-jump cadence for the labeling (see
      _label_components; default 0 = pure relax, which measured fastest
      even on percolating overlap domains). Regular-grid problems get a
      ~4x cheaper phase from houdayer_sweep_grid (roll-based labeling,
      23 -> 5.4 ms at M=48 N=6400); sample_icm routes there
      automatically for LatticeProblems.
    Returns (s1', s2', flipped (N,) bool).
    """
    q_neg = (s1 * s2) < 0  # (N,)
    adj = problem.nbr_J != 0.0  # (N, maxnb); pad slots carry J = 0
    active = (
        adj & q_neg[:, None] & jnp.take(q_neg, problem.nbr_idx, axis=0)
    )
    labels = _label_components(active, problem.nbr_idx,
                               jump_every=jump_every)
    coins = jax.random.bernoulli(key, 0.5, (problem.nspins,))
    flip = q_neg & jnp.take(coins, labels, axis=0)
    return jnp.where(flip, -s1, s1), jnp.where(flip, -s2, s2), flip


def _seg_min_scan(vals, link_prev, axis):
    """Per-site min over its maximal connected run along `axis`
    (circular). link_prev[..., c] True means site c is connected to site
    (c - 1) mod n. Runs are segmented log-depth `associative_scan`s, so
    one pass propagates labels across a whole row — the lattice
    fast path's answer to the generic relax loop's one-hop-per-round.
    """
    from jax import lax

    n = vals.shape[axis]

    def op(a, b):
        va, ga = a
        vb, gb = b
        return jnp.where(gb, jnp.minimum(va, vb), vb), ga & gb

    # circular: double the axis so every run shorter than the full ring
    # is contiguous in some window; a full ring still reaches every site
    v2 = jnp.concatenate([vals, vals], axis=axis)
    g2 = jnp.concatenate([link_prev, link_prev], axis=axis)
    fwd = lax.associative_scan(op, (v2, g2), axis=axis)[0]
    fwd = lax.slice_in_dim(fwd, n, 2 * n, axis=axis)
    # backward pass (run suffix): reverse, where "previous" = next site
    link_next = jnp.roll(link_prev, -1, axis=axis)
    vr = jnp.flip(vals, axis=axis)
    gr = jnp.flip(link_next, axis=axis)
    v2 = jnp.concatenate([vr, vr], axis=axis)
    g2 = jnp.concatenate([gr, gr], axis=axis)
    bwd = lax.associative_scan(op, (v2, g2), axis=axis)[0]
    bwd = jnp.flip(lax.slice_in_dim(bwd, n, 2 * n, axis=axis), axis=axis)
    return jnp.minimum(fwd, bwd)


def _label_components_lattice(link_left, link_up, init):
    """Component labels on an L x L (optionally periodic) lattice bond
    graph via alternating row/column segmented min-scans.

    Each round propagates the running minimum across ENTIRE connected
    row / column runs (log-depth scans), so round COUNT scales with the
    cluster's turning number instead of its hop diameter, at the
    per-round constant of XLA's associative_scan lowering (doubled axes,
    flips, O(log n) slice/concat stages, x4 scans per round); that
    trade-off has not been measured on the GPU. Kept as the opt-in
    labeler it is (exact; union-find-oracle tested); the generic relax
    is the default. Fixed point =
    per-component min of `init` (frozen -1 seeds propagate like any
    other minimum).
    """

    def cond(state):
        labels, changed = state
        return changed

    def body(state):
        labels, _ = state
        new = _seg_min_scan(labels, link_left, axis=-1)
        new = _seg_min_scan(new, link_up, axis=-2)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return labels


def classical_sw_sweep_lattice(problem, s, key, temp):
    """classical_sw_sweep specialized to LatticeProblem coupling planes:
    the FK draw lives on the j_right / j_down planes (each bond stored
    once — no symmetrization pass) and components are labeled with
    segmented row/column min-scans (_label_components_lattice).

    s: (L*L,) float +/-1 flat spins; same contract as classical_sw_sweep.
    """
    L = problem.L
    k_sp, k_h, k_coin = jax.random.split(key, 3)
    sp = s.reshape(L, L).astype(jnp.float32)

    de_r = 2.0 * problem.j_right * sp * jnp.roll(sp, -1, axis=-1)
    de_d = 2.0 * problem.j_down * sp * jnp.roll(sp, -1, axis=-2)
    u = jax.random.uniform(k_sp, (2, L, L))
    active_right = u[0] < _bond_prob(de_r, temp)  # (r,c) <-> (r,c+1)
    active_down = u[1] < _bond_prob(de_d, temp)   # (r,c) <-> (r+1,c)
    link_left = jnp.roll(active_right, 1, axis=-1)
    link_up = jnp.roll(active_down, 1, axis=-2)

    de_h = 2.0 * problem.h_plane * sp
    ghosted = jax.random.uniform(k_h, (L, L)) < _bond_prob(de_h, temp)
    init = jnp.where(
        ghosted, -1, jnp.arange(L * L, dtype=jnp.int32).reshape(L, L))
    labels = _label_components_lattice(link_left, link_up, init)

    coins = jax.random.bernoulli(k_coin, 0.5, (L * L,))
    flip = (labels >= 0) & coins[jnp.maximum(labels, 0).reshape(-1)].reshape(
        L, L)
    return jnp.where(flip, -sp, sp).reshape(s.shape)


def spacetime_sw_sweep(problem, confs, key, temp, gamma, b,
                       lookuptable=None):
    """Full space-time Swendsen-Wang sweep for PIQMC — every FK cluster
    of the (P, N) extended system updates in one labeling pass.

    Beyond-reference completion of the cluster family: wolff_update grows
    and flips ONE cluster per call (the reference's move, qmc.pyx:693-697);
    this draws the same satisfied-bond FK graph (spatial B J_ij, temporal
    -jperp, optional bath -T_eff lut[d-1]) once, labels every component
    with the min-label relax (`_label_components` cost model: one round
    per hop of the largest component's eccentricity — the same price as
    one Wolff BFS), and flips each component on an independent fair coin.
    Fields use the ghost-spin construction via -1 label seeds, exactly as
    classical_sw_sweep; exactness is histogram-tested against the
    extended Gibbs measure (tests/test_cluster_exact.py).

    confs: (P, N) float +/-1, unbatched (vmap over a chain axis).
    """
    slices, nspins = confs.shape
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    k_sp, k_t, k_bath, k_h, k_coin = jax.random.split(key, 5)

    s = confs.astype(jnp.float32)
    s_nb = jnp.take(s, problem.nbr_idx, axis=1)  # (P, N, maxnb)

    # satisfied-bond FK draw — one draw per undirected pair (wolff_update
    # rule="local" conventions)
    de_sp = 2.0 * b * problem.nbr_J[None] * s[:, :, None] * s_nb
    lower = jnp.arange(nspins)[:, None] < problem.nbr_idx
    u_sp = jax.random.uniform(k_sp, de_sp.shape)
    active_sp = lower[None] & (u_sp < _bond_prob(de_sp, teff))
    active_full = _symmetrize_spatial(active_sp, problem.nbr_idx)

    de_t = -2.0 * jp * s * jnp.roll(s, -1, axis=0)
    u_t = jax.random.uniform(k_t, de_t.shape)
    active_up = u_t < _bond_prob(de_t, teff)  # slice k <-> k+1 (mod P)
    dn_active = jnp.roll(active_up, 1, axis=0)

    active_bath = None
    if lookuptable is not None:
        lut = jnp.asarray(lookuptable)
        off = (jnp.arange(slices)[None, :]
               - jnp.arange(slices)[:, None]) % slices
        st = s.T  # (N, P)
        de_b = (
            -2.0 * teff * lut[jnp.maximum(off - 1, 0)][None]
            * st[:, :, None] * st[:, None, :]
        )
        p_b = jnp.where(off[None] > 0, _bond_prob(de_b, teff), 0.0)
        u_b = _mirror_upper(jax.random.uniform(
            k_bath, (nspins, slices, slices)))
        active_bath = u_b < p_b  # (N, P, P)

    # ghost bonds for the field term; frozen components relax to -1
    de_h = 2.0 * b * problem.h[None, :] * s
    ghosted = jax.random.uniform(k_h, de_h.shape) < _bond_prob(de_h, teff)
    flat = jnp.arange(slices * nspins, dtype=jnp.int32).reshape(
        slices, nspins)
    labels = jnp.where(ghosted, -1, flat)
    big = slices * nspins

    def cond(state):
        return state[1]

    def body(state):
        labels, _ = state
        nb_lab = jnp.where(
            active_full, jnp.take(labels, problem.nbr_idx, axis=1), big)
        new = jnp.minimum(labels, jnp.min(nb_lab, axis=-1))
        new = jnp.minimum(
            new, jnp.where(active_up, jnp.roll(labels, -1, axis=0), big))
        new = jnp.minimum(
            new, jnp.where(dn_active, jnp.roll(labels, 1, axis=0), big))
        if active_bath is not None:
            lt = labels.T  # (N, P)
            bmin = jnp.min(
                jnp.where(active_bath, lt[:, None, :], big), axis=-1)
            new = jnp.minimum(new, bmin.T)
        return new, jnp.any(new != labels)

    labels, _ = jax.lax.while_loop(cond, body, (labels, jnp.bool_(True)))

    coins = jax.random.bernoulli(k_coin, 0.5, (slices * nspins,))
    flip = (labels >= 0) & coins[jnp.maximum(labels, 0).reshape(-1)].reshape(
        slices, nspins)
    return jnp.where(flip, -confs, confs)
