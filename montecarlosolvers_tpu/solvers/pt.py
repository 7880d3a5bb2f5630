"""Parallel tempering (replica exchange) — a production extension beyond
the reference's capability surface (it has no replica-exchange component;
SURVEY.md §2), designed for the accelerator: the ladder is a batch axis through the
split-checkerboard engine, and exchanges permute temperature LABELS, not
configurations — the (M, N) state arrays never move, only an (M,)
replica_of_rung map does. That makes an accepted swap free of gathers and
makes the whole sampler shardable over rungs by plain GSPMD annotation
(shard the leading axis; the only cross-device traffic is the (M,)
energy/kinetic gather of the exchange test — bitwise-validated on the
8-device virtual mesh in tests/test_pt.py).

After every `swap_every` sweeps, adjacent rung pairs (alternating
even/odd anchors per attempt) exchange with the standard acceptance

    p = min(1, exp((1/T_i - 1/T_j)(E_i - E_j))),

which preserves the product of Gibbs measures (validated by the exact
per-temperature histogram test in tests/test_pt.py).

Two further extensions:
  * `sample_piqmc` — quantum parallel tempering: the ladder runs along the
    transverse field Gamma at fixed T. Swapping configurations between
    adjacent Gamma rungs changes only the kinetic term -J_perp(Gamma) K(x)
    of the extended Hamiltonian (K = sum of Trotter-neighbor products), so
    p = min(1, exp(-(J_perp_i - J_perp_j)(K_i - K_j)/T_eff)).
  * `tune_ladder` — equalizes measured adjacent-rung swap rates by
    redistributing rungs along the cumulative swap resistance.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.ops.metropolis import (
    colored_metropolis_sweep,
    metropolis_accept,
)
from montecarlosolvers_tpu.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu.schedules import jperp as jperp_of


def _exchange_perm(key, parity, de_pair, temp):
    """Masked adjacent-pair exchange. de_pair[k] is the Metropolis energy
    of swapping rungs (k, k+1) at temperature `temp`; anchors are rungs
    with k % 2 == parity. Returns (perm (M,), accept_anchor (M,))."""
    M = de_pair.shape[0]
    idx = jnp.arange(M)
    is_anchor = (idx % 2 == parity) & (idx + 1 < M)
    partner = jnp.where(is_anchor, idx + 1, jnp.where(
        (idx % 2 != parity) & (idx > 0), idx - 1, idx))
    u = jax.random.uniform(key, (M,))
    # log-form accept (floor-free; ops/metropolis.py)
    accept_anchor = is_anchor & metropolis_accept(de_pair, temp, u)
    # an index participates in a swap if it's an accepted anchor or the
    # partner of one
    accept = accept_anchor | jnp.roll(accept_anchor, 1)
    perm = jnp.where(accept, partner, idx)
    return perm, accept_anchor


@partial(jax.jit, static_argnames=("nsweeps", "swap_every", "collect_energy",
                                   "per_pair_rates"))
def sample(problem, temps, states, key, nsweeps, swap_every=1,
           collect_energy=False, per_pair_rates=False):
    """Run parallel tempering.

    Args:
      problem: IsingProblem or LatticeProblem.
      temps: (M,) temperature ladder (ascending or descending).
      states: (M, N) one configuration per rung.
      nsweeps: total sweeps per replica.
      swap_every: exchange attempt cadence.
      per_pair_rates: also return the (M-1,) per-adjacent-pair acceptance
        rates (the tune_ladder signal).

    Returns:
      (states, swap_rate[, energies (nsweeps, M)][, pair_rates (M-1,)]).
    """
    temps = jnp.asarray(temps)
    keys = jax.random.split(key, nsweeps)

    M = temps.shape[0]

    from montecarlosolvers_tpu.models.dense import DenseProblem
    from montecarlosolvers_tpu.ops import split as split_ops

    use_split = False
    if isinstance(problem, DenseProblem):
        from montecarlosolvers_tpu.ops.dense_sweep import dense_metropolis_sweep

        state = states

        def _sweep(states, k, t_rep):
            # rungs are the chain axis; per-rung temps broadcast through
            # the per-chain acceptance of the dense engine
            return dense_metropolis_sweep(problem, states, k, t_rep)

        _energy, _permute = problem.energy, (lambda s, perm: s[perm])
    elif split_ops.supports_split(problem):
        # production engine for lattices: the whole (M, N) ladder is one
        # maskless split-checkerboard state with a per-rung temperature
        # column (same dispatch solvers.sa.anneal uses)
        use_split = True
        sl = split_ops.build_split(problem)
        state = split_ops.pack_classical(sl, states)

        def _sweep(state, k, t_rep):
            return split_ops.sa_split_sweep(sl, *state, k, t_rep[:, None])

        def _energy(state):
            return split_ops.classical_energy_split(sl, *state)

        def _permute(state, perm):
            return tuple(x[perm] for x in state)
    else:
        state = states

        def _sweep(states, k, t_rep):
            return colored_metropolis_sweep(problem, states, k, t_rep[:, None])

        _energy, _permute = problem.energy, (lambda s, perm: s[perm])

    # Label-permutation exchange: replica configurations NEVER move —
    # an accepted swap exchanges the rungs' temperature labels instead.
    # Physically identical to exchanging configurations, but the carry's
    # only permuted object is the (M,) replica_of_rung map, so the big
    # state arrays stay put (no M x N gather per exchange, and under
    # rung sharding no cross-device state movement at all — the only
    # collective a sharded run needs is the (M,) energy gather).
    idx = jnp.arange(M)
    beta = 1.0 / temps
    nxt = jnp.clip(idx + 1, 0, M - 1)

    def body(carry, k):
        state, ror, nacc, natt_pair, natt = carry
        k1, k2, k3 = jax.random.split(k, 3)
        # labels = rung of each replica (inverse of replica_of_rung)
        labels = jnp.zeros((M,), jnp.int32).at[ror].set(
            idx.astype(jnp.int32)
        )
        state = _sweep(state, k1, temps[labels])
        i = natt  # sweep counter doubles as swap parity clock
        do_swap = (i % swap_every) == 0
        parity = (i // swap_every) % 2

        def with_swap(ror):
            e_rung = _energy(state)[ror]  # rung-ordered energies
            delta = (beta - beta[nxt]) * (e_rung - e_rung[nxt])
            perm, accept_anchor = _exchange_perm(k2, parity, -delta, 1.0)
            return ror[perm], accept_anchor

        ror, acc = jax.lax.cond(
            do_swap, with_swap, lambda r: (r, jnp.zeros((M,), bool)), ror,
        )
        # anchors attempted this step: k % 2 == parity, k+1 < M
        attempted = do_swap & (idx % 2 == parity) & (idx + 1 < M)
        e = _energy(state)[ror] if collect_energy else None
        return (state, ror, nacc + acc, natt_pair + attempted, natt + 1), e

    zero = jnp.zeros((M,), jnp.int32)
    ror0 = jnp.arange(M, dtype=jnp.int32)
    (state, ror, nacc, natt_pair, _), es = jax.lax.scan(
        body, (state, ror0, zero, zero, jnp.asarray(0)), keys
    )
    state = _permute(state, ror)  # return rung-ordered, as documented
    states = (
        split_ops.unpack_classical(sl, *state) if use_split else state
    )
    swap_rate = nacc.sum() / jnp.maximum(natt_pair.sum(), 1)
    out = (states, swap_rate)
    if collect_energy:
        out = out + (es,)
    if per_pair_rates:
        out = out + ((nacc / jnp.maximum(natt_pair, 1))[:-1],)
    return out


@partial(jax.jit, static_argnames=("nsweeps", "swap_every", "global_moves",
                                   "per_pair_rates"))
def sample_piqmc(problem, gammas, temp, confs, key, nsweeps, b=1.0,
                 swap_every=1, global_moves=False, per_pair_rates=False):
    """Quantum parallel tempering: replica exchange along a transverse-
    field ladder at fixed temperature.

    Each rung m runs space-time-colored PIQMC sweeps at Gamma = gammas[m];
    adjacent rungs exchange (by Gamma-label permutation — configurations
    stay put, see `sample`). Only the kinetic term -J_perp K(x),
    K(x) = sum_{i,k} s_i^k s_i^{k+1}, differs between rungs, so the
    exchange acceptance is

        p = min(1, exp(-(J_perp_i - J_perp_j)(K_i - K_j)/T_eff)),

    which preserves the product of extended-Gibbs measures (validated
    against exact histograms in tests/test_pt.py).

    confs: (M, P, N). Returns (confs, swap_rate[, pair_rates (M-1,)]).
    """
    gammas = jnp.asarray(gammas)
    M = gammas.shape[0]
    slices = confs.shape[-2]
    teff = temp * slices
    jps = jperp_of(gammas, teff)
    keys = jax.random.split(key, nsweeps)

    from montecarlosolvers_tpu.ops import split as split_ops

    use_split = split_ops.supports_split(problem, slices)
    if use_split:
        # production engine: the whole (M, P, N) ladder is one maskless
        # split-checkerboard state with a per-rung J_perp vector, in place
        # of the vmapped generic engine
        sl = split_ops.build_split(problem)
        state = split_ops.pack_qmc(sl, confs)

        def _sweep(state, k1, k3, g_rep):
            state = split_ops.qmc_split_sweep(
                sl, *state, k1, temp, g_rep, b
            )
            if global_moves:
                state = split_ops.qmc_split_global(sl, *state, k3, temp, b)
            return state

        def _kin(state):
            return split_ops.qmc_split_kinetic(sl, *state)

        def _permute(state, perm):
            return tuple(x[perm] for x in state)
    else:
        state = confs

        def _sweep(confs, k1, k3, g_rep):
            ks = jax.random.split(k1, M)
            confs = jax.vmap(
                lambda c, kk, g: piqmc_ops.local_sweep(
                    problem, c, kk, temp, g, b
                )
            )(confs, ks, g_rep)
            if global_moves:
                confs = piqmc_ops.global_line_moves(
                    problem, confs, k3, temp, b
                )
            return confs

        def _kin(confs):
            return jnp.sum(
                confs * jnp.roll(confs, -1, axis=-2), axis=(-1, -2)
            )

        def _permute(confs, perm):
            return confs[perm]

    # Label-permutation exchange (see `sample`): configurations stay put,
    # the Gamma labels move — no (M, P, N) gather per exchange, and rung
    # sharding needs only the (M,) kinetic-term gather.
    idx = jnp.arange(M)
    nxt = jnp.clip(idx + 1, 0, M - 1)

    def body(carry, k):
        state, ror, nacc, natt_pair, natt = carry
        k1, k2, k3 = jax.random.split(k, 3)
        labels = jnp.zeros((M,), jnp.int32).at[ror].set(
            idx.astype(jnp.int32)
        )
        state = _sweep(state, k1, k3, gammas[labels])
        i = natt
        do_swap = (i % swap_every) == 0
        parity = (i // swap_every) % 2

        def with_swap(ror):
            kk = _kin(state)[ror]  # rung-ordered kinetic terms
            de = (jps - jps[nxt]) * (kk - kk[nxt])
            perm, acc = _exchange_perm(k2, parity, de, teff)
            return ror[perm], acc

        ror, acc = jax.lax.cond(
            do_swap, with_swap,
            lambda r: (r, jnp.zeros((M,), bool)), ror,
        )
        attempted = do_swap & (idx % 2 == parity) & (idx + 1 < M)
        return (state, ror, nacc + acc, natt_pair + attempted, natt + 1), None

    zero = jnp.zeros((M,), jnp.int32)
    ror0 = jnp.arange(M, dtype=jnp.int32)
    (state, ror, nacc, natt_pair, _), _ = jax.lax.scan(
        body, (state, ror0, zero, zero, jnp.asarray(0)), keys
    )
    state = _permute(state, ror)  # rung-ordered return, as documented
    confs = (
        split_ops.unpack_qmc(sl, *state) if use_split else state
    )
    swap_rate = nacc.sum() / jnp.maximum(natt_pair.sum(), 1)
    if per_pair_rates:
        return confs, swap_rate, (nacc / jnp.maximum(natt_pair, 1))[:-1]
    return confs, swap_rate


def sample_icm(problem, temps, states, key, nsweeps, swap_every=1,
               houdayer_every=2, collect_energy=False, per_pair_rates=False,
               grid_bonds=None):
    """Isoenergetic cluster moves + parallel tempering (ICM,
    Zhu-Ochoa-Katzgraber 2015): TWO independent PT ladders run side by
    side, and every `houdayer_every` sweeps the same-rung replica pair
    exchanges energy through rejection-free Houdayer cluster flips
    (ops/cluster.houdayer_sweep — every q = -1 overlap domain coin-flips
    in both replicas). This is the cluster move that DOES work on spin
    glasses: the flipped domains live where the two replicas disagree,
    so they never suffer the FK percolation failure that
    bench/cluster_value.py measures.

    Args:
      problem: LatticeProblem or generic IsingProblem (dense problems are
        not supported — on a complete graph the overlap domain is one
        component and the move degenerates to a global flip).
      temps: (M,) temperature ladder.
      states: (2, M, N) — one configuration per ladder per rung.
      houdayer_every: cluster-move cadence (sweeps). 0 disables the
        cluster moves entirely — the two ladders then run as independent
        PT through the exact same code path, which is the honest
        equal-everything baseline for measuring what the Houdayer phases
        buy (bench/icm_value.py).
      grid_bonds: optional per-axis bond masks for regular-grid
        instances (ops/cluster.grid_bonds_from_edges) — routes the
        Houdayer labeling through the roll-based grid labeler
        (slope-measured 23 -> 5.4 ms per phase at M=48, N=6400). Built
        automatically for LatticeProblems from their coupling planes.

    Returns:
      (states (2, M, N) rung-ordered, swap_rate, houdayer_flip_frac
       [, energies (nsweeps, 2, M)][, pair_rates (M-1,), mean of ladders]).
    """
    from montecarlosolvers_tpu.models.dense import DenseProblem
    from montecarlosolvers_tpu.ops import split as split_ops

    if isinstance(problem, DenseProblem):
        raise ValueError("sample_icm needs a sparse/lattice problem")
    if grid_bonds is None and hasattr(problem, "j_right"):
        # LatticeProblem: the coupling planes ARE the per-axis bond masks
        grid_bonds = (problem.j_down != 0.0, problem.j_right != 0.0)
    gp = problem.to_generic() if hasattr(problem, "j_right") else problem
    return _icm_impl(
        problem, gp, jnp.asarray(temps), states, key, int(nsweeps),
        int(swap_every), int(houdayer_every), bool(collect_energy),
        bool(per_pair_rates), split_ops.supports_split(problem),
        grid_bonds,
    )


@partial(jax.jit, static_argnames=("nsweeps", "swap_every", "houdayer_every",
                                   "collect_energy", "per_pair_rates",
                                   "use_split"))
def _icm_impl(problem, gp, temps, states, key, nsweeps, swap_every,
              houdayer_every, collect_energy, per_pair_rates, use_split,
              grid_bonds=None):
    from montecarlosolvers_tpu.ops import split as split_ops
    from montecarlosolvers_tpu.ops.cluster import (
        houdayer_sweep,
        houdayer_sweep_grid,
    )

    if grid_bonds is not None:
        def _houdayer(a, c, kk):
            return houdayer_sweep_grid(grid_bonds, a, c, kk)
    else:
        def _houdayer(a, c, kk):
            return houdayer_sweep(gp, a, c, kk)

    M = temps.shape[0]
    keys = jax.random.split(key, nsweeps)
    idx = jnp.arange(M)
    beta = 1.0 / temps
    nxt = jnp.clip(idx + 1, 0, M - 1)

    if use_split:
        sl = split_ops.build_split(problem)
        state = split_ops.pack_classical(sl, states)  # halves (2, M, Nh)

        def _sweep(state, k, t_rep):
            return split_ops.sa_split_sweep(sl, *state, k, t_rep[..., None])

        def _energy(state):
            return split_ops.classical_energy_split(sl, *state)  # (2, M)

        def _unpack(state):
            return split_ops.unpack_classical(sl, *state)

        def _pack(full):
            return split_ops.pack_classical(sl, full)
    else:
        state = states

        def _sweep(states, k, t_rep):
            return colored_metropolis_sweep(gp, states, k, t_rep[..., None])

        _energy = gp.energy

        def _unpack(states):
            return states

        _pack = _unpack

    def _inv(ror):  # (2, M) replica_of_rung -> rung_of_replica
        return jax.vmap(
            lambda r: jnp.zeros((M,), jnp.int32).at[r].set(
                idx.astype(jnp.int32)
            )
        )(ror)

    def body(carry, k):
        state, ror, nacc, natt_pair, h_sum, h_cnt, natt = carry
        k1, k2, k3 = jax.random.split(k, 3)
        labels = _inv(ror)  # (2, M)
        state = _sweep(state, k1, temps[labels])
        i = natt
        do_swap = (i % swap_every) == 0
        parity = (i // swap_every) % 2

        def with_swap(ror):
            e_rung = jnp.take_along_axis(_energy(state), ror, axis=1)
            delta = (beta - beta[nxt])[None] * (e_rung - e_rung[:, nxt])
            perms, accs = jax.vmap(
                lambda d, kk: _exchange_perm(kk, parity, -d, 1.0)
            )(delta, jax.random.split(k2, 2))
            return jnp.take_along_axis(ror, perms, axis=1), accs

        ror, acc = jax.lax.cond(
            do_swap, with_swap,
            lambda r: (r, jnp.zeros((2, M), bool)), ror,
        )

        def with_h(state):
            full = _unpack(state)  # (2, M, N)
            r1 = full[0][ror[0]]  # rung-aligned pairs
            r2 = full[1][ror[1]]
            r1n, r2n, flips = jax.vmap(_houdayer)(
                r1, r2, jax.random.split(k3, M)
            )
            lab = _inv(ror)
            full = jnp.stack([r1n[lab[0]], r2n[lab[1]]])
            return _pack(full), flips.mean()

        if houdayer_every:  # static: 0 compiles the PT-only baseline
            do_h = (i % houdayer_every) == 0
            state, hfrac = jax.lax.cond(
                do_h, with_h, lambda s: (s, jnp.float32(0.0)), state,
            )
        else:
            do_h = jnp.bool_(False)
            hfrac = jnp.float32(0.0)
        attempted = do_swap & (idx % 2 == parity) & (idx + 1 < M)
        e = (
            jnp.take_along_axis(_energy(state), ror, axis=1)
            if collect_energy else None
        )
        return (
            state, ror, nacc + acc, natt_pair + attempted,
            h_sum + hfrac, h_cnt + do_h.astype(jnp.int32), natt + 1,
        ), e

    zero = jnp.zeros((M,), jnp.int32)
    ror0 = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32), (2, M))
    (state, ror, nacc, natt_pair, h_sum, h_cnt, _), es = jax.lax.scan(
        body,
        (state, ror0, jnp.zeros((2, M), jnp.int32), zero,
         jnp.float32(0.0), jnp.asarray(0, jnp.int32), jnp.asarray(0)),
        keys,
    )
    full = _unpack(state)
    states = jnp.stack([full[0][ror[0]], full[1][ror[1]]])
    swap_rate = nacc.sum() / jnp.maximum(2 * natt_pair.sum(), 1)
    h_frac = h_sum / jnp.maximum(h_cnt, 1)
    out = (states, swap_rate, h_frac)
    if collect_energy:
        out = out + (es,)
    if per_pair_rates:
        out = out + ((nacc.sum(0) / jnp.maximum(2 * natt_pair, 1))[:-1],)
    return out


def tune_ladder(problem, temps, key, rounds=4, sweeps_per_round=200,
                floor=0.02):
    """Equalize adjacent-rung swap rates by redistributing rungs along the
    measured cumulative swap resistance (-log rate), keeping the endpoints
    fixed. Returns (temps, pair_rates) from the final measurement round.

    The standard PT failure mode is a bottleneck pair whose energy
    distributions barely overlap; equal resistance per gap maximizes
    round-trip flow for a fixed rung budget.
    """
    temps = np.asarray(temps, dtype=np.float64)
    asc = temps[0] < temps[-1]
    if not asc:
        temps = temps[::-1]
    M = temps.shape[0]
    n = problem.nspins
    k_init, key = jax.random.split(key)
    states = jnp.where(
        jax.random.bernoulli(k_init, 0.5, (M, n)), 1.0, -1.0
    )
    pair_rates = None
    for _ in range(rounds):
        key, kr = jax.random.split(key)
        states, _, pair_rates = sample(
            problem, jnp.asarray(temps, jnp.float32), states, kr,
            sweeps_per_round, per_pair_rates=True,
        )
        # clip away from BOTH ends: rate == 1.0 would give zero resistance
        # everywhere and np.interp over a constant cumsum would collapse
        # the whole ladder onto t_max
        r = np.clip(np.asarray(pair_rates), floor, 1.0 - floor)
        res = -np.log(r)  # (M-1,) resistance per gap
        c = np.concatenate([[0.0], np.cumsum(res)])
        targets = np.linspace(0.0, c[-1], M)
        logt = np.interp(targets, c, np.log(temps))
        temps = np.exp(logt)
    if not asc:
        temps = temps[::-1]
    return jnp.asarray(temps, jnp.float32), np.asarray(pair_rates)


def tune_ladder_piqmc(problem, gammas, temp, key, rounds=4,
                      sweeps_per_round=200, floor=0.02, global_moves=False,
                      slices=None, confs=None):
    """Equalize adjacent-rung swap rates of the quantum (Gamma) ladder —
    the transverse-field analog of `tune_ladder`, using `sample_piqmc`'s
    per-pair rates as the resistance signal. Rungs are redistributed along
    the cumulative -log(rate) in log(Gamma) space, endpoints fixed.

    Pass either `confs` ((M, P, N) initial configurations) or `slices`
    (P; random init). Returns (gammas, pair_rates) from the final round.
    """
    gammas = np.asarray(gammas, dtype=np.float64)
    asc = gammas[0] < gammas[-1]
    if not asc:
        gammas = gammas[::-1]
    M = gammas.shape[0]
    if confs is None:
        if slices is None:
            raise ValueError("pass confs or slices")
        k_init, key = jax.random.split(key)
        confs = jnp.where(
            jax.random.bernoulli(k_init, 0.5, (M, slices, problem.nspins)),
            1.0, -1.0,
        )
    pair_rates = None
    for _ in range(rounds):
        key, kr = jax.random.split(key)
        confs, _, pair_rates = sample_piqmc(
            problem, jnp.asarray(gammas, jnp.float32), temp, confs, kr,
            sweeps_per_round, global_moves=global_moves, per_pair_rates=True,
        )
        r = np.clip(np.asarray(pair_rates), floor, 1.0 - floor)
        c = np.concatenate([[0.0], np.cumsum(-np.log(r))])
        targets = np.linspace(0.0, c[-1], M)
        gammas = np.exp(np.interp(targets, c, np.log(gammas)))
    if not asc:
        gammas = gammas[::-1]
    return jnp.asarray(gammas, jnp.float32), np.asarray(pair_rates)


def geometric_ladder(t_min, t_max, num):
    """Geometric temperature ladder — the standard PT spacing.

    Sizing guidance (measured on the 80x80 benchmark): adjacent-rung swap
    acceptance needs the rung ratio - 1 to scale like 1/sqrt(N) (energy
    distributions must overlap). 16 rungs over [0.2, 3] gave a 4% swap
    rate at N = 6400; 96 rungs over [0.3, 2.5] gave 60%. Tune `num` until
    `sample`'s swap_rate lands in the 20-60% band.
    """
    return jnp.geomspace(t_min, t_max, num)
