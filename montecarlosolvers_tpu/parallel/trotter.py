"""Trotter-axis sharding: PIQMC with the imaginary-time ring spread over a
device mesh axis.

The reference's Trotter loop is a serial array axis (qmc.pyx:99,
confs (N, P)); its only "context scaling" knob is P (SURVEY.md §5). Here P
becomes a mesh axis: each device owns a contiguous block of slices and the
periodic nearest-slice J_perp coupling (qmc.pyx:126-138) is a halo exchange
of one boundary slice per direction via `lax.ppermute` to the two ring
neighbours, the only Trotter traffic per phase. Whole-line global moves (qmc.pyx:405-438)
reduce their dE with a `psum`; the all-to-all bath term (qmc.pyx:270-273)
uses an `all_gather` of the spin lines (the ring-attention-style pattern
noted in SURVEY.md §5).

RNG: local-slice phases fold the device's replica index into the key
(independent streams per shard); global-move acceptance uses the unfolded
key so every shard of a line reaches the same accept decision.

Cross-shard semantics note: with the bath term, slices owned by different
devices update concurrently against a bath-field snapshot refreshed once
per local slice step — the cross-device analog of the reference's own
tolerated asynchrony (its `prange` races, SURVEY.md §5 "race detection").
Concurrent slices are always p_local apart, so the STRONG J_perp ring
term is never concurrently stale; the p_local == 1 case (where it would
be — synchronous ring dynamics with a provably wrong stationary measure)
ring-colors the device axis instead (_sharded_dissipative_sweep). Pinned
by the 3-sigma equilibrium test vs the single-device sequential bath
engine in tests/test_parallel.py (round 5 — that test caught the
p_local == 1 anti-alignment the old compile/run bar missed).

Two engines (both validated on the virtual CPU mesh, and on four GPUs
through `python chip_smoke.py --four-cards`):

  * `anneal_sharded` — generic masked engine on any problem graph; the
    halo exchange runs once per color phase ON PURPOSE: boundary slices
    contain sites of every spatial color, so the remote Trotter
    neighbors they read change every phase — hoisting the exchange out
    of the color loop would evaluate dE against stale spins and
    reintroduce the async races the coloring exists to eliminate.
  * `anneal_sharded_split` (VERDICT r3 #5) — the PRODUCTION
    split-checkerboard quarter layout (ops/split.py) with the q =
    half-Trotter axis sharded over "replica": the Trotter coupling of
    each quarter update is exactly one boundary half-slice `ppermute`
    per direction (the X phase needs yo[q-1]/ye[q+1]; the Y phase the
    updated xo[q-1]/xe[q+1]), global line moves psum their per-shard
    partial dE, and the bfloat16 carry flows through unchanged. With
    rng="replicated" (each shard slices its rows out of the full-shape
    uniform draw) the local sweep is BITWISE identical to the
    single-device split engine — the test bar tests/test_parallel.py
    pins; rng="sharded" folds the shard index for independent per-shard
    streams at zero redundant uniform generation (production default).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.6 stable API
    from jax import shard_map as _shard_map

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map_old

    def shard_map(f, mesh, in_specs, out_specs):
        return _shard_map_old(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs)

from montecarlosolvers_tpu.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu.ops.piqmc import BATH_PRECISION, spacetime_num_phases
from montecarlosolvers_tpu.schedules import jperp as jperp_of
from montecarlosolvers_tpu import schedules as sched_mod


def _conf_spec(ndim, chains_sharded):
    """PartitionSpec for confs (..., P, N): P on "replica", leading batch on
    "chains" when present."""
    lead = ("chains",) if chains_sharded else (None,)
    extra = (None,) * (ndim - 3) if ndim > 2 else ()
    if ndim == 2:
        return P("replica", None)
    return P(*(lead + extra + ("replica", None)))


def _halo_exchange(confs_l, axis):
    """Fetch the slice above and below this shard's block over the ring.

    confs_l: (..., P_local, N). Returns (s_up, s_dn) with the same shape,
    where s_up[k] is the global slice k-1 and s_dn[k] the global slice k+1.
    """
    ndev = lax.axis_size(axis)
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
    from_left = lax.ppermute(confs_l[..., -1, :], axis, fwd)
    from_right = lax.ppermute(confs_l[..., 0, :], axis, bwd)
    s_up = jnp.concatenate([from_left[..., None, :], confs_l[..., :-1, :]], axis=-2)
    s_dn = jnp.concatenate([confs_l[..., 1:, :], from_right[..., None, :]], axis=-2)
    return s_up, s_dn


def _local_phase_key(key, axis):
    me = lax.axis_index(axis)
    try:
        cme = lax.axis_index("chains")
    except NameError:  # chains axis absent from mesh
        cme = 0
    return jax.random.fold_in(jax.random.fold_in(key, me), cme)


def _sharded_local_sweep(problem, num_phases, confs_l, key, temp, gamma, b,
                         axis):
    """One space-time colored local sweep on a Trotter shard, using the
    combined coloring phase(i, k_global) = (spatial_color + k) mod m (see
    ops.piqmc.spacetime_num_phases)."""
    ndev = lax.axis_size(axis)
    p_local = confs_l.shape[-2]
    slices = p_local * ndev
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    b_coeff = -2.0 * b
    me = lax.axis_index(axis)
    global_idx = me * p_local + jnp.arange(p_local)
    spatial_colors = jnp.argmax(problem.color_masks, axis=0)
    stc = (spatial_colors[None, :] + global_idx[:, None]) % num_phases

    key = _local_phase_key(key, axis)
    u = jax.random.uniform(key, confs_l.shape)
    for p in range(num_phases):
        s_up, s_dn = _halo_exchange(confs_l, axis)
        field = problem.local_fields(confs_l)
        de = b_coeff * confs_l * field + 2.0 * confs_l * jp * (s_up + s_dn)
        accept = metropolis_accept(de, teff, u) & (stc == p)
        confs_l = jnp.where(accept, -confs_l, confs_l)
    return confs_l


def _sharded_dissipative_sweep(problem, bath_rows, confs_l, key, temp, gamma,
                               b, axis):
    """Dissipative sweep on a Trotter shard: local slices update
    sequentially; the bath field against all P slices comes from an
    all_gather refreshed per local step. bath_rows: the full (P, P) bath
    matrix, rows selected by global index.

    Devices run their local slice loop in lockstep, so slices updating
    concurrently sit p_local apart on the Trotter ring. For p_local >= 2
    they are never ring-ADJACENT: the strong J_perp term always reads
    either fresh local state or a boundary slice whose staleness is the
    documented once-per-step snapshot asynchrony. At p_local == 1 every
    slice would update simultaneously — SYNCHRONOUS ring dynamics, whose
    stationary measure is wrong (it anti-aligns the Trotter lines; caught
    by tests/test_parallel.py's 3-sigma sharded-bath equilibrium test,
    round 5) — so that case ring-colors the device axis (2 phases for an
    even ring, 3 for odd) with a fresh all_gather per phase: adjacent
    slices never update together, and only the weak all-to-all bath term
    retains the snapshot semantics."""
    ndev = lax.axis_size(axis)
    p_local = confs_l.shape[-2]
    slices = p_local * ndev
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    b_coeff = -2.0 * b
    me = lax.axis_index(axis)
    key = _local_phase_key(key, axis)

    def updated_slice(confs_l, full, kloc, kglob, kkey):
        s_k = jax.lax.dynamic_index_in_dim(
            confs_l, kloc, axis=-2, keepdims=False
        )
        s_up = jax.lax.dynamic_index_in_dim(
            full, (kglob - 1) % slices, axis=-2, keepdims=False
        )
        s_dn = jax.lax.dynamic_index_in_dim(
            full, (kglob + 1) % slices, axis=-2, keepdims=False
        )
        row = jnp.take(bath_rows, kglob, axis=0)  # (P,)
        bath_field = jnp.einsum("p,...pn->...n", row, full,
                                precision=BATH_PRECISION)
        for c in range(problem.num_colors):
            field = problem.local_fields(s_k)
            de = (
                b_coeff * s_k * field
                + 2.0 * s_k * jp * (s_up + s_dn)
                + 2.0 * teff * s_k * bath_field
            )
            u = jax.random.uniform(jax.random.fold_in(kkey, c), s_k.shape)
            accept = metropolis_accept(de, teff, u) & problem.color_masks[c]
            s_k = jnp.where(accept, -s_k, s_k)
        return s_k

    if p_local == 1:
        # ring-color the device axis; static phase loop keeps the
        # all_gather collective un-diverged across devices
        ncol = 2 if ndev % 2 == 0 else 3
        my_color = jnp.where(
            (ndev % 2 == 1) & (me == ndev - 1), 2, me % 2
        )

        def slice_body(kloc, confs_l):
            kkey = jax.random.fold_in(key, kloc)
            for ph in range(ncol):
                full = lax.all_gather(
                    confs_l, axis, axis=confs_l.ndim - 2, tiled=True
                )
                s_new = updated_slice(confs_l, full, kloc, me, kkey)
                s_old = jax.lax.dynamic_index_in_dim(
                    confs_l, kloc, axis=-2, keepdims=False
                )
                s_k = jnp.where(my_color == ph, s_new, s_old)
                confs_l = jax.lax.dynamic_update_index_in_dim(
                    confs_l, s_k, kloc, axis=-2
                )
            return confs_l
    else:
        def slice_body(kloc, confs_l):
            kglob = me * p_local + kloc
            full = lax.all_gather(
                confs_l, axis, axis=confs_l.ndim - 2, tiled=True
            )
            s_k = updated_slice(
                confs_l, full, kloc, kglob, jax.random.fold_in(key, kloc)
            )
            return jax.lax.dynamic_update_index_in_dim(
                confs_l, s_k, kloc, axis=-2
            )

    return jax.lax.fori_loop(0, p_local, slice_body, confs_l)


def _sharded_global_moves(problem, confs_l, key, temp, b, axis):
    """Whole-line flips with psum'd dE; acceptance uniforms are shared
    across the replica axis so all shards of a line agree."""
    ndev = lax.axis_size(axis)
    slices = confs_l.shape[-2] * ndev
    teff = temp * slices
    b_coeff = -2.0 * b
    try:
        key = jax.random.fold_in(key, lax.axis_index("chains"))
    except NameError:
        pass
    for c in range(problem.num_colors):
        field = problem.local_fields(confs_l)
        de = lax.psum(jnp.sum(b_coeff * confs_l * field, axis=-2), axis)
        u = jax.random.uniform(jax.random.fold_in(key, c), de.shape)
        accept = metropolis_accept(de, teff, u) & problem.color_masks[c]
        confs_l = jnp.where(accept[..., None, :], -confs_l, confs_l)
    return confs_l


@partial(
    jax.jit,
    static_argnames=("mesh", "mcsteps", "global_moves", "chains_sharded"),
)
def anneal_sharded(problem, a_sched, b_sched, temp, confs, key, mesh,
                   mcsteps=1, global_moves=False, lookuptable=None,
                   chains_sharded=False):
    """PIQMC anneal with the Trotter axis sharded over mesh axis "replica"
    (and optionally the chain batch over "chains").

    confs: (..., P, N) with P divisible by the replica axis size.
    Semantics match solvers.qmc.anneal; see module docstring for the
    cross-shard RNG/bath conventions.
    """
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])

    slices = confs.shape[-2]
    num_phases = spacetime_num_phases(problem.num_colors, slices)
    if lookuptable is not None:
        from montecarlosolvers_tpu.ops.piqmc import bath_matrix

        bath_rows = bath_matrix(lookuptable, slices)
    else:
        bath_rows = None

    spec_confs = _conf_spec(confs.ndim, chains_sharded)

    def sweep(confs_l, k, gamma, bcur):
        k1, k2 = jax.random.split(k)
        if bath_rows is None:
            confs_l = _sharded_local_sweep(
                problem, num_phases, confs_l, k1, temp, gamma, bcur, "replica"
            )
        else:
            confs_l = _sharded_dissipative_sweep(
                problem, bath_rows, confs_l, k1, temp, gamma, bcur, "replica"
            )
        if global_moves:
            confs_l = _sharded_global_moves(problem, confs_l, k2, temp, bcur,
                                            "replica")
        return confs_l

    sharded_sweep = shard_map(
        sweep,
        mesh,
        in_specs=(spec_confs, P(), P(), P()),
        out_specs=spec_confs,
    )

    def body(confs, x):
        gamma, bcur, k = x
        return sharded_sweep(confs, k, gamma, bcur), None

    confs, _ = jax.lax.scan(body, confs, (a, b, keys))
    return confs


# --------------------------------------------------------------------------
# Split-checkerboard quarter layout, Trotter-sharded (VERDICT r3 #5)
# --------------------------------------------------------------------------


def _ring_up(v, axis):
    """Global jnp.roll(v, +1, axis=-2) across the sharded q axis: element
    q reads q-1, the first local row reading the previous shard's last —
    one boundary half-slice ppermute."""
    ndev = lax.axis_size(axis)
    fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
    from_left = lax.ppermute(v[..., -1, :], axis, fwd)
    return jnp.concatenate([from_left[..., None, :], v[..., :-1, :]], axis=-2)


def _ring_dn(v, axis):
    """Global jnp.roll(v, -1, axis=-2): element q reads q+1."""
    ndev = lax.axis_size(axis)
    bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
    from_right = lax.ppermute(v[..., 0, :], axis, bwd)
    return jnp.concatenate([v[..., 1:, :], from_right[..., None, :]], axis=-2)


def _split_draw(key, s, q_local, axis, rng):
    """Per-quarter acceptance/proposal uniforms on a q-sharded array.

    rng="replicated": every shard draws the FULL (q_total, Nh) array with
    the unfolded key and slices its own rows — bitwise identical to the
    single-device engine's draw, at ndev-times redundant generation.
    rng="sharded": fold (replica, chains) indices for independent streams
    with no redundancy (production default)."""
    if rng == "replicated":
        ndev = lax.axis_size(axis)
        me = lax.axis_index(axis)
        u = jax.random.uniform(
            key, s.shape[:-2] + (q_local * ndev, s.shape[-1])
        )
        return lax.dynamic_slice_in_dim(u, me * q_local, q_local, axis=-2)
    kk = jax.random.fold_in(key, lax.axis_index(axis))
    try:
        kk = jax.random.fold_in(kk, lax.axis_index("chains"))
    except NameError:
        pass
    return jax.random.uniform(kk, s.shape)


def _split_sharded_sweep(sl, xe, xo, ye, yo, key, temp, gamma, b, axis, rng):
    """One space-time colored sweep on the q-sharded quarter layout —
    the sharded form of ops/split.qmc_split_sweep (same quarter update
    order, same key-split structure; jnp.roll on q becomes _ring_up/_dn)."""
    from montecarlosolvers_tpu.ops.split import _spatial_field

    ndev = lax.axis_size(axis)
    q_local = xe.shape[-2]
    slices = 2 * q_local * ndev
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    bc = -2.0 * b
    wa, ha = sl.w_ab[:, 0], sl.h_ab[0]
    wb, hb = sl.w_ab[:, 1], sl.h_ab[1]
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def upd(s, f_sp_h, tr, k):
        de = bc * s * f_sp_h + 2.0 * s * jp * tr
        u = _split_draw(k, s, q_local, axis, rng)
        return jnp.where(metropolis_accept(de, teff, u), -s, s)

    xe = upd(xe, _spatial_field(wa, ye, sl.K) + ha, yo + _ring_up(yo, axis), k1)
    xo = upd(xo, _spatial_field(wb, yo, sl.K) + hb, ye + _ring_dn(ye, axis), k2)
    ye = upd(ye, _spatial_field(wb, xe, sl.K) + hb, xo + _ring_up(xo, axis), k3)
    yo = upd(yo, _spatial_field(wa, xo, sl.K) + ha, xe + _ring_dn(xe, axis), k4)
    return xe, xo, ye, yo


def _split_sharded_global(sl, xe, xo, ye, yo, key, temp, b, axis):
    """Whole-line flips on the q-sharded quarter layout: per-shard partial
    dE summed with a psum; acceptance uniforms use the replica-unfolded
    key so every shard of a line agrees (chains fold per chain shard)."""
    from montecarlosolvers_tpu.ops.split import _spatial_field

    ndev = lax.axis_size(axis)
    slices = 2 * xe.shape[-2] * ndev
    teff = temp * slices
    bc = -2.0 * b
    ka, kb = jax.random.split(key)
    try:
        ka = jax.random.fold_in(ka, lax.axis_index("chains"))
        kb = jax.random.fold_in(kb, lax.axis_index("chains"))
    except NameError:
        pass
    wa, ha = sl.w_ab[:, 0], sl.h_ab[0]
    wb, hb = sl.w_ab[:, 1], sl.h_ab[1]

    de = bc * lax.psum(
        jnp.sum(xe * (_spatial_field(wa, ye, sl.K) + ha), axis=-2)
        + jnp.sum(yo * (_spatial_field(wa, xo, sl.K) + ha), axis=-2),
        axis,
    )
    u = jax.random.uniform(ka, de.shape)
    m = jnp.where(metropolis_accept(de, teff, u), -1.0, 1.0)[..., None, :]
    xe = xe * m.astype(xe.dtype)
    yo = yo * m.astype(yo.dtype)

    de = bc * lax.psum(
        jnp.sum(ye * (_spatial_field(wb, xe, sl.K) + hb), axis=-2)
        + jnp.sum(xo * (_spatial_field(wb, yo, sl.K) + hb), axis=-2),
        axis,
    )
    u = jax.random.uniform(kb, de.shape)
    m = jnp.where(metropolis_accept(de, teff, u), -1.0, 1.0)[..., None, :]
    ye = ye * m.astype(ye.dtype)
    xo = xo * m.astype(xo.dtype)
    return xe, xo, ye, yo


@partial(
    jax.jit,
    static_argnames=("mesh", "mcsteps", "global_moves", "chains_sharded",
                     "rng", "state_dtype"),
)
def anneal_sharded_split(problem, a_sched, b_sched, temp, confs, key, mesh,
                         mcsteps=1, global_moves=False, chains_sharded=False,
                         rng="sharded", state_dtype=jnp.bfloat16):
    """PIQMC anneal on the PRODUCTION split-checkerboard engine with the
    half-Trotter (q) axis sharded over mesh axis "replica" (and optionally
    the chain batch over "chains").

    confs: (..., P, N) on an even-L LatticeProblem with P/2 divisible by
    the replica axis size. Semantics match ops/split.qmc_anneal_split;
    the Trotter halo is one boundary half-slice ppermute per direction
    per quarter phase. rng="replicated" makes the local sweep BITWISE
    identical to the single-device split engine (chains must then be
    unsharded; global-move dE reductions may still differ in the last
    ULP, so the bitwise bar applies to global_moves=False);
    rng="sharded" (default) folds shard indices for independent streams.
    """
    from montecarlosolvers_tpu.ops import split as split_ops

    if rng not in ("sharded", "replicated"):
        raise ValueError(f"rng must be 'sharded' or 'replicated', got {rng!r}")
    sl = split_ops.build_split(problem)
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])
    in_dtype = confs.dtype
    state = tuple(
        q.astype(state_dtype) for q in split_ops.pack_qmc(sl, confs)
    )

    replica_size = mesh.shape["replica"]
    q_total = state[0].shape[-2]
    if q_total % replica_size:
        raise ValueError(
            f"P/2 = {q_total} must divide by the replica axis size "
            f"{replica_size}"
        )

    spec_q = _conf_spec(state[0].ndim, chains_sharded)

    def sweep(xe, xo, ye, yo, k, gamma, bcur):
        k1, k2 = jax.random.split(k)
        st = _split_sharded_sweep(
            sl, xe, xo, ye, yo, k1, temp, gamma, bcur, "replica", rng
        )
        if global_moves:
            st = _split_sharded_global(sl, *st, k2, temp, bcur, "replica")
        return st

    sharded_sweep = shard_map(
        sweep,
        mesh,
        in_specs=(spec_q,) * 4 + (P(), P(), P()),
        out_specs=(spec_q,) * 4,
    )

    def body(state, x):
        gamma, bcur, k = x
        return sharded_sweep(*state, k, gamma, bcur), None

    state, _ = jax.lax.scan(body, state, (a, b, keys))
    return split_ops.unpack_qmc(sl, *(q.astype(in_dtype) for q in state))


# --------------------------------------------------------------------------
# Trotter-sharded Wolff clusters (distributed frontier BFS)
# --------------------------------------------------------------------------


def _wolff_sharded_update(problem, confs_l, key, temp, gamma, b, axis, rule,
                          lookuptable):
    """One Wolff cluster update on a Trotter-sharded (P_local, N) block —
    the distributed form of ops/cluster.wolff_update (same bond rules,
    same key-split structure).

    Bond draws are REPLICATED: every shard draws the full-shape uniforms
    with the shared key and slices its own rows, so the update is BITWISE
    identical to the single-device engine on fieldless problems (with
    fields, the accept's psum'd field sum may differ from the single-device
    reduction in the last ULP). The draw cost is ndev-times redundant but
    negligible next to the BFS, whose per-iteration halo — one boundary
    row `ppermute` per temporal direction, plus an `all_gather` of the
    frontier when bath bonds are present — is the actual distributed cost.
    The `while_loop` still stops at the seed component's eccentricity: the
    continue flag is a psum'd any-frontier bit, so all shards step in
    lockstep and exit together (closes the ARCHITECTURE §8 "Trotter-sharded
    Wolff clusters" gap; reference stack growth: qmc.pyx:711-786).
    """
    from montecarlosolvers_tpu.ops.cluster import (
        _bond_prob,
        _mirror_upper,
        _symmetrize_spatial,
    )

    ndev = lax.axis_size(axis)
    p_local, nspins = confs_l.shape
    slices = p_local * ndev
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    me = lax.axis_index(axis)

    k_seed_key, k_sp, k_t, k_site, k_bath, k_acc = jax.random.split(key, 6)
    seed_spin = jax.random.randint(k_seed_key, (), 0, nspins)
    seed_slice = jax.random.randint(k_site, (), 0, slices)
    row = seed_slice - me * p_local
    in_block = (row >= 0) & (row < p_local)
    row_c = jnp.clip(row, 0, p_local - 1)

    s = confs_l.astype(jnp.float32)
    pad = problem.nbr_idx == jnp.arange(nspins)[:, None]
    s_nb = jnp.take(s, problem.nbr_idx, axis=1)  # (P_local, N, maxnb)

    def my_rows(u, ax):
        return lax.dynamic_slice_in_dim(u, me * p_local, p_local, axis=ax)

    if rule == "local":
        de_sp = 2.0 * b * problem.nbr_J[None] * s[:, :, None] * s_nb
        de_t = -2.0 * jp * s * _ring_dn(s, axis)
        lower = jnp.arange(nspins)[:, None] < problem.nbr_idx
        gate_sp = lower[None, :, :]
        gate_t = True
        same = same_full = None
    else:
        kval = lax.psum(
            jnp.where(in_block, confs_l[row_c, seed_spin], 0), axis
        )
        same = confs_l == kval
        field = problem.local_fields(s)
        up = _ring_up(s, axis)
        dn = _ring_dn(s, axis)
        de_site = -2.0 * b * kval * field + 2.0 * jp * kval * (up + dn)
        de_sp = jnp.take(de_site, problem.nbr_idx, axis=1)
        de_t = _ring_dn(de_site, axis)
        nb_same = jnp.take(same, problem.nbr_idx, axis=1)
        gate_sp = same[:, :, None] & nb_same & (~pad)[None, :, :]
        gate_t = same & _ring_dn(same, axis)

    u_sp = my_rows(jax.random.uniform(k_sp, (slices, nspins, problem.maxnb)), 0)
    u_t = my_rows(jax.random.uniform(k_t, (slices, nspins)), 0)
    active_sp = gate_sp & (u_sp < _bond_prob(de_sp, teff))
    active_up = gate_t & (u_t < _bond_prob(de_t, teff))

    active_bath = None
    if lookuptable is not None:
        lut = jnp.asarray(lookuptable)
        s_full = lax.all_gather(s, axis, axis=0, tiled=True)  # (P, N)
        st_full = s_full.T  # (N, P)
        gidx = me * p_local + jnp.arange(p_local)
        off = (jnp.arange(slices)[None, :] - gidx[:, None]) % slices
        de_b = (
            -2.0 * teff * lut[jnp.maximum(off - 1, 0)][None]
            * s.T[:, :, None] * st_full[:, None, :]
        )  # (N, P_local, P)
        p_b = jnp.where(off[None] > 0, _bond_prob(de_b, teff), 0.0)
        u_b = _mirror_upper(jax.random.uniform(k_bath, (nspins, slices, slices)))
        active_bath = my_rows(u_b, 1) < p_b
        if rule != "local":
            same_full = lax.all_gather(same, axis, axis=0, tiled=True)
            active_bath = (
                active_bath & same.T[:, :, None] & same_full.T[:, None, :]
            )

    active_full = _symmetrize_spatial(active_sp, problem.nbr_idx)
    dn_active = _ring_up(active_up, axis)

    seed = jnp.zeros((p_local, nspins), bool)
    seed = seed.at[row_c, seed_spin].set(in_block)

    def cond(state):
        _, _, go = state
        return go

    def body(state):
        visited, frontier, _ = state
        nb_f = jnp.take(frontier, problem.nbr_idx, axis=1)
        reach = jnp.any(nb_f & active_full, axis=-1)
        reach |= active_up & _ring_dn(frontier, axis)
        reach |= dn_active & _ring_up(frontier, axis)
        if active_bath is not None:
            f_full = lax.all_gather(frontier, axis, axis=0, tiled=True)
            reach |= jnp.any(active_bath & f_full.T[:, None, :], axis=-1).T
        new_frontier = reach & ~visited
        go = lax.psum(jnp.any(new_frontier).astype(jnp.int32), axis) > 0
        return visited | new_frontier, new_frontier, go

    comp, _, _ = lax.while_loop(cond, body, (seed, seed, jnp.asarray(True)))

    if rule == "local":
        de_h = -2.0 * b * lax.psum(
            jnp.sum(problem.h[None, :] * s, axis=(0, 1), where=comp), axis
        )
        accept = metropolis_accept(de_h, teff, jax.random.uniform(k_acc, ()))
        flip = comp & accept
    else:
        flip = comp & same
    return jnp.where(flip, -confs_l, confs_l)


def anneal_wolff_sharded(problem, a_sched, b_sched, temp, confs, key, mesh,
                         mcsteps=1, rule="local", lookuptable=None):
    """PIQMC anneal with Wolff cluster updates, the Trotter axis sharded
    over mesh axis "replica" (one cluster per MC step, matching
    solvers.qmc.anneal_wolff / qmc.pyx:693-697).

    confs: (P, N) unbatched, P divisible by the replica axis size. The
    cluster engine walks explicit neighbor tables, so LatticeProblems are
    converted to the padded-gather representation (eagerly, before the
    jit boundary — the conversion inspects concrete couplings). Bitwise
    identical to the single-device anneal_wolff on fieldless problems (see
    _wolff_sharded_update); batch chains by running independent calls or
    sharding chains with parallel/mesh.py instead — a chains axis inside
    the distributed BFS would couple every chain to the slowest frontier.
    """
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    return _anneal_wolff_sharded_jit(
        problem, a_sched, b_sched, temp, confs, key, mesh,
        mcsteps=mcsteps, rule=rule, lookuptable=lookuptable,
    )


@partial(jax.jit, static_argnames=("mesh", "mcsteps", "rule"))
def _anneal_wolff_sharded_jit(problem, a_sched, b_sched, temp, confs, key,
                              mesh, mcsteps=1, rule="local",
                              lookuptable=None):
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])

    replica_size = mesh.shape["replica"]
    if confs.shape[-2] % replica_size:
        raise ValueError(
            f"P = {confs.shape[-2]} must divide by the replica axis size "
            f"{replica_size}"
        )

    def run(confs_l, keys, a, b):
        def body(confs_l, x):
            gamma, bcur, k = x
            confs_l = _wolff_sharded_update(
                problem, confs_l, k, temp, gamma, bcur, "replica", rule,
                lookuptable,
            )
            return confs_l, None

        confs_l, _ = jax.lax.scan(body, confs_l, (a, b, keys))
        return confs_l

    return shard_map(
        run,
        mesh,
        in_specs=(P("replica", None), P(), P(), P()),
        out_specs=P("replica", None),
    )(confs, keys, a, b)


def _spacetime_sw_sharded_sweep(problem, confs_l, key, temp, gamma, b, axis,
                                lookuptable):
    """One full space-time Swendsen-Wang sweep on a Trotter-sharded
    (P_local, N) block — the distributed form of
    ops/cluster.spacetime_sw_sweep (same bond rules, same key-split
    structure).

    Bond/coin draws are REPLICATED (full-shape uniforms from the shared
    key, each shard slicing its own rows), and the min-label relax's
    fixed point — every component's minimum global flat index — is
    iteration-order independent, so the sweep is BITWISE identical to
    the single-device engine. Per relax round the halo is one boundary
    label row `ppermute` per temporal direction (plus an `all_gather`
    of the labels when bath bonds are present); the continue flag is a
    psum'd any-changed bit so all shards exit together.
    """
    from montecarlosolvers_tpu.ops.cluster import (
        _bond_prob,
        _mirror_upper,
        _symmetrize_spatial,
    )

    ndev = lax.axis_size(axis)
    p_local, nspins = confs_l.shape
    slices = p_local * ndev
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    me = lax.axis_index(axis)

    k_sp, k_t, k_bath, k_h, k_coin = jax.random.split(key, 5)
    s = confs_l.astype(jnp.float32)
    s_nb = jnp.take(s, problem.nbr_idx, axis=1)

    def my_rows(u, ax):
        return lax.dynamic_slice_in_dim(u, me * p_local, p_local, axis=ax)

    de_sp = 2.0 * b * problem.nbr_J[None] * s[:, :, None] * s_nb
    lower = jnp.arange(nspins)[:, None] < problem.nbr_idx
    u_sp = my_rows(
        jax.random.uniform(k_sp, (slices, nspins, problem.maxnb)), 0)
    active_sp = lower[None] & (u_sp < _bond_prob(de_sp, teff))
    active_full = _symmetrize_spatial(active_sp, problem.nbr_idx)

    de_t = -2.0 * jp * s * _ring_dn(s, axis)
    u_t = my_rows(jax.random.uniform(k_t, (slices, nspins)), 0)
    active_up = u_t < _bond_prob(de_t, teff)
    dn_active = _ring_up(active_up, axis)

    active_bath = None
    if lookuptable is not None:
        lut = jnp.asarray(lookuptable)
        s_full = lax.all_gather(s, axis, axis=0, tiled=True)  # (P, N)
        st_full = s_full.T
        gidx = me * p_local + jnp.arange(p_local)
        off = (jnp.arange(slices)[None, :] - gidx[:, None]) % slices
        de_b = (
            -2.0 * teff * lut[jnp.maximum(off - 1, 0)][None]
            * s.T[:, :, None] * st_full[:, None, :]
        )  # (N, P_local, P)
        p_b = jnp.where(off[None] > 0, _bond_prob(de_b, teff), 0.0)
        u_b = _mirror_upper(
            jax.random.uniform(k_bath, (nspins, slices, slices)))
        active_bath = my_rows(u_b, 1) < p_b

    # ghost seeds (-1) freeze field-bonded components through the relax
    de_h = 2.0 * b * problem.h[None, :] * s
    u_h = my_rows(jax.random.uniform(k_h, (slices, nspins)), 0)
    ghosted = u_h < _bond_prob(de_h, teff)
    flat = (
        (me * p_local + jnp.arange(p_local, dtype=jnp.int32))[:, None]
        * nspins
        + jnp.arange(nspins, dtype=jnp.int32)[None, :]
    )
    labels0 = jnp.where(ghosted, -1, flat)
    big = slices * nspins

    def cond(state):
        return state[1]

    def body(state):
        labels, _ = state
        nb_lab = jnp.where(
            active_full, jnp.take(labels, problem.nbr_idx, axis=1), big)
        new = jnp.minimum(labels, jnp.min(nb_lab, axis=-1))
        new = jnp.minimum(
            new, jnp.where(active_up, _ring_dn(labels, axis), big))
        new = jnp.minimum(
            new, jnp.where(dn_active, _ring_up(labels, axis), big))
        if active_bath is not None:
            l_full = lax.all_gather(labels, axis, axis=0, tiled=True)
            bmin = jnp.min(
                jnp.where(active_bath, l_full.T[:, None, :], big), axis=-1)
            new = jnp.minimum(new, bmin.T)
        changed = lax.psum(
            jnp.any(new != labels).astype(jnp.int32), axis) > 0
        return new, changed

    labels, _ = lax.while_loop(cond, body, (labels0, jnp.bool_(True)))

    coins = jax.random.bernoulli(k_coin, 0.5, (slices * nspins,))
    flip = (labels >= 0) & coins[
        jnp.maximum(labels, 0).reshape(-1)].reshape(p_local, nspins)
    return jnp.where(flip, -confs_l, confs_l)


def anneal_sw_sharded(problem, a_sched, b_sched, temp, confs, key, mesh,
                      mcsteps=1, lookuptable=None):
    """PIQMC anneal with full space-time Swendsen-Wang sweeps, the
    Trotter axis sharded over mesh axis "replica" — the distributed form
    of solvers.qmc.anneal_sw, BITWISE identical to it (the SW labels'
    fixed point is deterministic, so even field problems match exactly,
    unlike the sharded Wolff accept's psum'd field reduction).

    confs: (P, N) unbatched, P divisible by the replica axis size.
    """
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    return _anneal_sw_sharded_jit(
        problem, a_sched, b_sched, temp, confs, key, mesh,
        mcsteps=mcsteps, lookuptable=lookuptable,
    )


@partial(jax.jit, static_argnames=("mesh", "mcsteps"))
def _anneal_sw_sharded_jit(problem, a_sched, b_sched, temp, confs, key,
                           mesh, mcsteps=1, lookuptable=None):
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])

    replica_size = mesh.shape["replica"]
    if confs.shape[-2] % replica_size:
        raise ValueError(
            f"P = {confs.shape[-2]} must divide by the replica axis size "
            f"{replica_size}"
        )

    def run(confs_l, keys, a, b):
        def body(confs_l, x):
            gamma, bcur, k = x
            # mirror the single-device _anneal_sw_impl key split so the
            # trajectories stay bitwise comparable
            _, k2 = jax.random.split(k)
            confs_l = _spacetime_sw_sharded_sweep(
                problem, confs_l, k2, temp, gamma, bcur, "replica",
                lookuptable,
            )
            return confs_l, None

        confs_l, _ = jax.lax.scan(body, confs_l, (a, b, keys))
        return confs_l

    return shard_map(
        run,
        mesh,
        in_specs=(P("replica", None), P(), P(), P()),
        out_specs=P("replica", None),
    )(confs, keys, a, b)
