"""Population annealing — weighted-ensemble thermal annealing.

The reference anneals independent chains (sa.Anneal, sa.pyx:19-101;
45 repetitions in the MST driver, examples/santoro80.py:258). Population
annealing (Hukushima & Iba 2003; Machta 2010; Weigel et al., "Monte
Carlo methods for massively parallel computers") is the literature-
standard massively-parallel extension of exactly that protocol: a
population of R replicas anneals down the same temperature schedule, but
between steps each replica is reweighted by exp(-dbeta*E) and resampled,
so the ensemble tracks the Gibbs distribution instead of falling out of
equilibrium. Free byproduct: an unbiased estimator of free-energy
differences, ln[Z(beta_end)/Z(beta_0)].

Design: the population is the batch axis through the same
engines solvers.sa uses (split-checkerboard for lattices, matmul blocked
for dense, masked colored otherwise), so the sweep hot path is identical
to `sa.anneal` at equal population. The PA-specific work per step — an
(R,) energy readout, a logsumexp, a cumsum and one row gather — is O(R)
against the O(R*N) sweep, and every piece is GSPMD-shardable over the
population axis (the resampling gather is the only cross-device traffic;
see __graft_entry__.dryrun_multichip's PA leg).

Resampling schemes:
  * "systematic" (default) — one uniform offset, stratified comb over the
    cumulative weights: lowest variance, the PA-literature standard.
  * "multinomial" — R independent categorical draws.

Weights accumulate across steps and the population resamples only when
the effective sample size drops below `ess_threshold * R` (the standard
always-resample protocol is ess_threshold=1.0, the default — with equal
weights ESS == R, so no-op resamples are skipped exactly).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from montecarlosolvers_tpu import schedules as sched_mod
from montecarlosolvers_tpu.ops.metropolis import colored_metropolis_sweep
from montecarlosolvers_tpu.ops import split as split_ops

SEGMENT = 100_000  # max schedule steps per device dispatch (see sa.SEGMENT)


def beta_linear(beta_end, num, beta_start=0.0):
    """Temperature schedule linear in BETA — the PA-native grid.

    A temperature-linear schedule (schedules.linear) has huge late dbeta
    jumps (1/T blows up as T -> 0) that collapse the effective sample
    size; PA quality is controlled by dbeta * std(E), so a uniform beta
    grid is the natural default. beta_start=0.0 makes the first
    temperature inf: a uniform-random population IS the exact Gibbs
    ensemble at beta=0, so ln Z estimates become absolute via
    uniform_log_z(n).
    """
    betas = np.linspace(beta_start, beta_end, num)
    with np.errstate(divide="ignore"):
        return jnp.asarray(1.0 / betas, jnp.float32)


def uniform_log_z(nspins):
    """ln Z at beta = 0 (2^N states): offset making `log_z` absolute when
    the run starts from uniform-random states at beta0 = 0."""
    return float(nspins) * float(np.log(2.0))


def _systematic_indices(key, w):
    """Stratified comb over the cumulative weights: index i draws the
    first replica j with cum[j] >= (i + u)/R. One uniform for the whole
    population; with equal weights this is exactly the identity."""
    r = w.shape[0]
    u = jax.random.uniform(key, (), dtype=w.dtype)
    cum = jnp.cumsum(w)
    pts = (jnp.arange(r, dtype=w.dtype) + u) / r
    return jnp.clip(jnp.searchsorted(cum, pts, side="left"), 0, r - 1)


def _engine(problem, state_in):
    """Shared sweep-engine dispatch (mirrors pt.sample): the population
    is the chain axis of the same kernels solvers.sa uses. Returns
    (state, sweep, energy, permute, unpack)."""
    from montecarlosolvers_tpu.models.dense import DenseProblem

    if isinstance(problem, DenseProblem):
        from montecarlosolvers_tpu.ops.dense_sweep import dense_metropolis_sweep

        state = state_in

        def _sweep(state, k, t):
            return dense_metropolis_sweep(problem, state, k, t)

        _energy = problem.energy
        _permute = lambda s, idx: s[idx]  # noqa: E731
        _unpack = lambda s: s  # noqa: E731
    elif split_ops.supports_split(problem):
        sl = split_ops.build_split(problem)
        state = split_ops.pack_classical(sl, state_in)

        def _sweep(state, k, t):
            return split_ops.sa_split_sweep(sl, *state, k, t)

        def _energy(state):
            return split_ops.classical_energy_split(sl, *state)

        def _permute(state, idx):
            return tuple(x[idx] for x in state)

        def _unpack(state):
            return split_ops.unpack_classical(sl, *state)
    else:
        state = state_in

        def _sweep(state, k, t):
            return colored_metropolis_sweep(problem, state, k, t)

        _energy = problem.energy
        _permute = lambda s, idx: s[idx]  # noqa: E731
        _unpack = lambda s: s  # noqa: E731
    return state, _sweep, _energy, _permute, _unpack


@partial(jax.jit, static_argnames=("mcsteps", "resample", "collect_stats"))
def _run(problem, temps, state_in, key, logw, log_z, beta_prev, anc,
         mcsteps, resample, collect_stats, ess_threshold):
    """One jitted segment of the PA scan. Engine dispatch mirrors
    pt.sample: the population is the chain axis of the same sweep
    kernels, and the resample is a leading-axis row gather."""
    state, _sweep, _energy, _permute, _unpack = _engine(problem, state_in)

    r = logw.shape[0]
    log_r = jnp.float32(np.log(r))

    def body(carry, x):
        state, logw, log_z, beta_prev, anc = carry
        temp, k = x
        k_rs, k_sweep = jax.random.split(k)
        beta = 1.0 / temp
        e = _energy(state).astype(jnp.float32)
        logw = logw - (beta - beta_prev) * e
        # normalize to mean weight 1, rolling the normalizer into log_z:
        # log_z accumulates ln[Z(beta)/Z(beta_prev)] estimates regardless
        # of whether this step resamples (standard SMC accounting)
        c = logsumexp(logw) - log_r
        log_z = log_z + c
        logw = logw - c
        w = jnp.exp(logw - log_r)  # normalized, sums to 1
        ess = 1.0 / jnp.sum(w * w)
        do_rs = ess < ess_threshold * r
        if resample == "systematic":
            idx = _systematic_indices(k_rs, w)
        else:  # multinomial
            idx = jax.random.categorical(k_rs, logw, shape=(r,))
        idx = jnp.where(do_rs, idx, jnp.arange(r))
        state = _permute(state, idx)
        anc = anc[idx]  # surviving-family lineage (Wang-Machta-Katzgraber)
        logw = jnp.where(do_rs, jnp.zeros_like(logw), logw)
        for i in range(mcsteps):
            state = _sweep(state, jax.random.fold_in(k_sweep, i), temp)
        stats = (ess, jnp.mean(e), do_rs) if collect_stats else None
        return (state, logw, log_z, beta, anc), stats

    keys = jax.random.split(key, temps.shape[0])
    (state, logw, log_z, beta_prev, anc), stats = jax.lax.scan(
        body, (state, logw, log_z, beta_prev, anc), (temps, keys)
    )
    return _unpack(state), logw, log_z, beta_prev, anc, stats


def sample(problem, temps, states, key, mcsteps=1, beta0=None,
           ess_threshold=1.0, resample="systematic", collect_stats=False,
           segment=SEGMENT):
    """Population-annealing run down the temperature schedule `temps`.

    Args:
      problem: IsingProblem / LatticeProblem / DenseProblem.
      temps: (S,) temperatures, all > 0 (inf allowed for beta = 0 grid
        points — see beta_linear). Each step reweights the population
        from the previous step's inverse temperature to 1/temps[k],
        resamples if ESS dropped below `ess_threshold * R`, then runs
        `mcsteps` sweeps at temps[k].
      states: (R, N) +/-1 population. For an absolute ln Z (beta0=0.0)
        this must be uniform random — the exact beta = 0 ensemble.
      key: PRNG key (deterministic replay, AnnealMA-style).
      beta0: inverse temperature the initial population is equilibrated
        at. Default None = 1/temps[0] (first reweight is a no-op; the
        SA-style usage). Pass 0.0 with uniform-random states for
        absolute free energies: ln Z(beta_end) = log_z + uniform_log_z(N).
      ess_threshold: resample when ESS < ess_threshold * R. 1.0 (default)
        = the standard every-step protocol (equal-weight steps skip the
        no-op exactly); lower values trade resampling-correlation for
        weight variance.
      resample: "systematic" (default) or "multinomial".
      collect_stats: also return per-step (ess, e_mean, resampled) arrays.
      segment: max schedule steps per device dispatch (sa.anneal's
        watchdog-safe segmentation; None disables).

    Returns:
      (states, log_z[, stats]): the final (R, N) population, the
      accumulated ln[Z(1/temps[-1]) / Z(beta0)] estimator, and — when
      collect_stats — a dict with "ess" (S,), "e_mean" (S,),
      "resampled" (S,), and "families" (int: surviving distinct initial
      lineages; R/families is the mean family size rho_t, the standard
      PA equilibration diagnostic). With ess_threshold=1.0 the returned population
      is equally weighted; below it, residual weights were normalized
      into log_z and the final population is weighted by exp(logw)
      (not returned; resample at the end by passing ess_threshold=1.0
      for the last step, or keep the default).
    """
    temps = jnp.asarray(temps, jnp.float32)
    beta_prev = jnp.float32(beta0 if beta0 is not None else 1.0 / temps[0])
    r = states.shape[0]
    logw = jnp.zeros((r,), jnp.float32)
    log_z = jnp.float32(0.0)
    anc = jnp.arange(r, dtype=jnp.int32)
    segs = sched_mod.segments(temps.shape[0], segment)
    stats_parts = []
    for lo, hi in segs:
        k = key if len(segs) == 1 else jax.random.fold_in(key, lo)
        states, logw, log_z, beta_prev, anc, stats = _run(
            problem, temps[lo:hi], states, k, logw, log_z, beta_prev, anc,
            mcsteps, resample, collect_stats,
            jnp.float32(ess_threshold),
        )
        if collect_stats:
            stats_parts.append(stats)
    if collect_stats:
        ess, e_mean, rs = (
            stats_parts[0]
            if len(stats_parts) == 1
            else tuple(jnp.concatenate(p) for p in zip(*stats_parts))
        )
        # surviving families: replicas descending from distinct initial
        # states — the PA literature's equilibration health metric
        # (R/families is the effective lineage multiplicity rho_t)
        families = int(np.unique(np.asarray(anc)).size)
        return states, log_z, {"ess": ess, "e_mean": e_mean,
                               "resampled": rs, "families": families}
    return states, log_z


# ---------------------------------------------------------------------------
# Adaptive-step PA (VERDICT r4 missing #2a): choose each dbeta on-device so
# the INCREMENTAL effective sample size lands on a fixed target fraction —
# the standard adaptive protocol (Barash-Weigel-et-al culling-fraction
# control). A fixed beta grid wastes steps where std(E) is small and
# collapses the population where it is large; the adaptive grid equalizes
# the damage per step.
# ---------------------------------------------------------------------------

def _ess_of(logw):
    """Effective sample size of a log-weight vector (Kish)."""
    return jnp.exp(2.0 * logsumexp(logw) - logsumexp(2.0 * logw))


def _solve_dbeta(logw, e, remaining, target_ess, iters=40):
    """Largest dbeta in [0, remaining] with ESS(logw - dbeta*e) >=
    target_ess, by bisection (ESS is monotone non-increasing in dbeta
    along an annealing direction for all practical energy spreads; 40
    halvings resolve dbeta to remaining * 2^-40)."""
    hi_ok = _ess_of(logw - remaining * e) >= target_ess

    def body(_, ab):
        a, b = ab
        mid = 0.5 * (a + b)
        ok = _ess_of(logw - mid * e) >= target_ess
        return jnp.where(ok, mid, a), jnp.where(ok, b, mid)

    a, _ = jax.lax.fori_loop(
        0, iters, body, (jnp.float32(0.0), remaining)
    )
    return jnp.where(hi_ok, remaining, a)


@partial(jax.jit, static_argnames=("max_steps", "mcsteps", "resample"))
def _run_adaptive(problem, beta_end, state_in, key, max_steps, mcsteps,
                  resample, target_frac, beta0):
    state, _sweep, _energy, _permute, _unpack = _engine(problem, state_in)
    r = state_in.shape[0]
    log_r = jnp.float32(np.log(r))
    target_ess = target_frac * r

    def body(carry, k):
        state, logw, log_z, beta, anc = carry
        k_rs, k_sweep = jax.random.split(k)
        done = beta >= beta_end

        # the ENTIRE live step sits under the cond: once beta_end is
        # reached, padded scan steps cost ~nothing (measured: leaving
        # the O(R*N) energy readout outside the cond made the padded
        # tail dominate the wall at max_steps >> n_steps)
        def live(args):
            state, logw, log_z, beta, anc = args
            e = _energy(state).astype(jnp.float32)
            db = _solve_dbeta(
                logw, e, jnp.maximum(beta_end - beta, 0.0), target_ess
            )
            beta = beta + db
            logw = logw - db * e
            c = logsumexp(logw) - log_r
            log_z = log_z + c
            logw = logw - c
            ess = _ess_of(logw)
            if resample == "systematic":
                idx = _systematic_indices(k_rs, jnp.exp(logw - log_r))
            else:
                idx = jax.random.categorical(k_rs, logw, shape=(r,))
            state = _permute(state, idx)
            anc = anc[idx]
            logw = jnp.zeros_like(logw)
            t = 1.0 / jnp.maximum(beta, 1e-30)
            for i in range(mcsteps):
                state = _sweep(state, jax.random.fold_in(k_sweep, i), t)
            return (state, logw, log_z, beta, anc), (beta, ess, e.mean())

        def dead(args):
            state, logw, log_z, beta, anc = args
            return args, (beta, jnp.float32(r), jnp.float32(0.0))

        carry, stats = jax.lax.cond(
            done, dead, live, (state, logw, log_z, beta, anc)
        )
        return carry, stats + (done,)

    anc0 = jnp.arange(r, dtype=jnp.int32)
    keys = jax.random.split(key, max_steps)
    (state, logw, log_z, beta, anc), (betas, ess, e_mean, done) = (
        jax.lax.scan(
            body,
            (state, jnp.zeros((r,), jnp.float32), jnp.float32(0.0),
             jnp.float32(beta0), anc0),
            keys,
        )
    )
    return _unpack(state), log_z, beta, anc, betas, ess, e_mean, done


def sample_adaptive(problem, beta_end, states, key, target_frac=0.9,
                    mcsteps=1, max_steps=400, beta0=0.0,
                    resample="systematic"):
    """Adaptive-step population annealing: anneal beta0 -> beta_end with
    each dbeta chosen ON-DEVICE so the incremental ESS stays at
    `target_frac * R` (bisection over the reweighting factor — the
    standard adaptive-PA protocol; beta_linear's fixed grid is the
    non-adaptive special case this replaces, VERDICT r4).

    The schedule length is data-dependent, so the scan runs `max_steps`
    padded steps: steps after beta reaches beta_end reweight by zero,
    skip their sweeps under a lax.cond, and are excluded from the
    returned diagnostics. If beta never reaches beta_end within
    max_steps, stats["reached"] is False and log_z covers only the
    traversed range — raise max_steps or lower target_frac.

    Args: as `sample`; beta0=0.0 with uniform-random states gives
      absolute ln Z via uniform_log_z(N). target_frac in (0, 1): ESS
      fraction kept per step (higher = smaller steps; 0.9 is standard).

    Returns:
      (states, log_z, stats) with stats = {"betas": (n_steps,) traversed
      grid, "ess": per-step ESS, "e_mean": per-step mean energy,
      "n_steps": int, "reached": bool, "families": int}.
    """
    states_out, log_z, beta, anc, betas, ess, e_mean, done = _run_adaptive(
        problem, jnp.float32(beta_end), states, key, int(max_steps),
        int(mcsteps), resample, jnp.float32(target_frac),
        jnp.float32(beta0),
    )
    done = np.asarray(done)
    n_steps = int((~done).sum())
    families = int(np.unique(np.asarray(anc)).size)
    stats = {
        "betas": np.asarray(betas)[:n_steps],
        "ess": np.asarray(ess)[:n_steps],
        "e_mean": np.asarray(e_mean)[:n_steps],
        "n_steps": n_steps,
        "reached": bool(n_steps < int(max_steps)),
        "families": families,
    }
    return states_out, log_z, stats


# ---------------------------------------------------------------------------
# Weighted run combining (VERDICT r4 missing #2b): independent PA runs are
# combined with weights proportional to their free-energy estimators
# exp(log_z_k) (Machta 2010 §V) — an observable's combined estimate stays
# unbiased even when single runs have collapsed to one family, because
# collapse inflates a run's weight variance, not its bias, and the
# cross-run weighting suppresses unlucky runs.
# ---------------------------------------------------------------------------

def combine_runs(log_zs, observables=None):
    """Combine K independent PA runs.

    Args:
      log_zs: (K,) per-run ln[Z-tilde] estimators (same beta range).
      observables: optional (K, ...) per-run observable estimates.

    Returns dict:
      log_z: combined estimator ln[(1/K) sum Z-tilde_k] — the unbiased
        arithmetic mean in Z-space.
      weights: (K,) normalized run weights prop. to exp(log_z_k).
      run_ess: Kish effective number of independent runs (K when all
        runs agree; -> 1 when one run dominates).
      observable: weights @ observables when observables is given.
    """
    lz = np.asarray(log_zs, dtype=np.float64)
    k = lz.shape[0]
    m = lz.max()
    w = np.exp(lz - m)
    out = {
        "log_z": float(m + np.log(w.sum() / k)),
        "weights": w / w.sum(),
        "run_ess": float(w.sum() ** 2 / (w * w).sum()),
    }
    if observables is not None:
        obs = np.asarray(observables, dtype=np.float64)
        out["observable"] = tuple(
            float(x) for x in (out["weights"] @ obs).reshape(-1)
        ) if obs.ndim > 1 else float(out["weights"] @ obs)
    return out


# ---------------------------------------------------------------------------
# Quantum population annealing (VERDICT r4 missing #2c): PA resampling over
# the PIQMC extended ensemble — the composition the round-4 pa_value README
# named as unbuilt. The population is a set of path configurations (R, P, N)
# annealed down a transverse-field schedule with importance resampling.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mcsteps", "resample", "collect_stats",
                                   "global_moves"))
def _run_piqmc(problem, gammas, temp, confs_in, key, logw, log_z, jp_prev,
               anc, b, mcsteps, resample, collect_stats, ess_threshold,
               global_moves):
    from montecarlosolvers_tpu.ops import piqmc as piqmc_ops

    r = logw.shape[0]
    slices = confs_in.shape[-2]
    teff = temp * slices
    log_r = jnp.float32(np.log(r))

    use_split = split_ops.supports_split(problem, slices)
    if use_split:
        sl = split_ops.build_split(problem)
        state = split_ops.pack_qmc(sl, confs_in)

        def _sweep(state, k1, k3, gamma):
            g_rep = jnp.full((r,), gamma)
            state = split_ops.qmc_split_sweep(sl, *state, k1, temp, g_rep, b)
            if global_moves:
                state = split_ops.qmc_split_global(sl, *state, k3, temp, b)
            return state

        def _kin(state):
            return split_ops.qmc_split_kinetic(sl, *state)

        def _permute(state, idx):
            return tuple(x[idx] for x in state)

        def _unpack(state):
            return split_ops.unpack_qmc(sl, *state)
    else:
        state = confs_in

        def _sweep(confs, k1, k3, gamma):
            ks = jax.random.split(k1, r)
            confs = jax.vmap(
                lambda c, kk: piqmc_ops.local_sweep(
                    problem, c, kk, temp, gamma, b
                )
            )(confs, ks)
            if global_moves:
                confs = piqmc_ops.global_line_moves(problem, confs, k3,
                                                    temp, b)
            return confs

        def _kin(confs):
            return jnp.sum(
                confs * jnp.roll(confs, -1, axis=-2), axis=(-1, -2)
            )

        _permute = lambda s, idx: s[idx]  # noqa: E731
        _unpack = lambda s: s  # noqa: E731

    def body(carry, x):
        state, logw, log_z, jp_prev, anc = carry
        gamma, k = x
        k_rs, k1, k3 = jax.random.split(k, 3)
        jp = sched_mod.jperp(gamma, teff)
        kk = _kin(state).astype(jnp.float32)
        # pi_Gamma(x) prop. exp(-(b E_sp - jp K)/T_eff): only the kinetic
        # term moves with Gamma (same accounting as pt.sample_piqmc)
        logw = logw + (jp - jp_prev) * kk / teff
        c = logsumexp(logw) - log_r
        log_z = log_z + c
        logw = logw - c
        w = jnp.exp(logw - log_r)
        ess = 1.0 / jnp.sum(w * w)
        do_rs = ess < ess_threshold * r
        if resample == "systematic":
            idx = _systematic_indices(k_rs, w)
        else:
            idx = jax.random.categorical(k_rs, logw, shape=(r,))
        idx = jnp.where(do_rs, idx, jnp.arange(r))
        state = _permute(state, idx)
        anc = anc[idx]
        logw = jnp.where(do_rs, jnp.zeros_like(logw), logw)
        for i in range(mcsteps):
            state = _sweep(state, jax.random.fold_in(k1, i),
                           jax.random.fold_in(k3, i), gamma)
        stats = (ess, do_rs) if collect_stats else None
        return (state, logw, log_z, jp, anc), stats

    keys = jax.random.split(key, gammas.shape[0])
    (state, logw, log_z, jp_prev, anc), stats = jax.lax.scan(
        body, (state, logw, log_z, jp_prev, anc), (gammas, keys)
    )
    return _unpack(state), logw, log_z, anc, stats


def sample_piqmc(problem, gammas, temp, confs, key, mcsteps=1, b=1.0,
                 gamma0=None, ess_threshold=1.0, resample="systematic",
                 global_moves=False, collect_stats=False):
    """Quantum population annealing: PA resampling over the PIQMC
    extended (path-integral) ensemble, the composition named unbuilt by
    VERDICT r4 (bench/pa_value.py). A population of R path
    configurations (R, P, N) runs space-time PIQMC sweeps down the
    transverse-field schedule `gammas`; between steps each configuration
    is reweighted by the Gamma-dependence of its extended Boltzmann
    weight

        pi_G(x) prop. exp(-(b*E_spatial(x) - J_perp(G)*K(x)) / T_eff),
        K(x) = sum_{i,k} s_i^k s_i^{k+1}  (T_eff = temp * P),

    i.e. dlogw = +(J_perp(G) - J_perp(G_prev)) * K(x) / T_eff — the same
    kinetic accounting pt.sample_piqmc's exchange test uses (J_perp
    transform of qmc.pyx:95). Resampling then keeps the ensemble ON the
    extended Gibbs distribution along the whole anneal, which is exactly
    what the plain PIQMC anneal (qmc.anneal, qmc.pyx:25-143) gives up at
    speed. log_z accumulates ln[Z_ext(G_end)/Z_ext(G_0)]
    (exact-enumeration-tested in tests/test_pa.py).

    Args:
      gammas: (S,) transverse-field schedule (descending for annealing).
      temp: per-slice temperature (T_eff = temp * P, qmc.pyx:85).
      confs: (R, P, N) +/-1 population.
      gamma0: Gamma the initial population is equilibrated at (default
        gammas[0]: first reweight is a no-op).
      Other args as `sample`.

    Returns:
      (confs, log_z[, stats]) with stats = {"ess": (S,),
      "resampled": (S,), "families": int} when collect_stats.
    """
    gammas = jnp.asarray(gammas, jnp.float32)
    r = confs.shape[0]
    slices = confs.shape[-2]
    teff = temp * slices
    jp0 = sched_mod.jperp(
        jnp.float32(gamma0 if gamma0 is not None else gammas[0]), teff
    )
    out, logw, log_z, anc, stats = _run_piqmc(
        problem, gammas, temp, confs, key, jnp.zeros((r,), jnp.float32),
        jnp.float32(0.0), jnp.float32(jp0),
        jnp.arange(r, dtype=jnp.int32), b, int(mcsteps), resample,
        bool(collect_stats), jnp.float32(ess_threshold), bool(global_moves),
    )
    if collect_stats:
        ess, rs = stats
        families = int(np.unique(np.asarray(anc)).size)
        return out, log_z, {"ess": ess, "resampled": rs,
                            "families": families}
    return out, log_z


@partial(jax.jit, static_argnames=("max_steps", "mcsteps", "resample",
                                   "global_moves"))
def _run_piqmc_adaptive(problem, jp_end, temp, confs_in, key, max_steps,
                        mcsteps, resample, target_frac, jp0, b,
                        global_moves):
    from montecarlosolvers_tpu.ops import piqmc as piqmc_ops

    r = confs_in.shape[0]
    slices = confs_in.shape[-2]
    teff = temp * slices
    log_r = jnp.float32(np.log(r))
    target_ess = target_frac * r

    use_split = split_ops.supports_split(problem, slices)
    if use_split:
        sl = split_ops.build_split(problem)
        state = split_ops.pack_qmc(sl, confs_in)

        def _sweep(state, k1, k3, gamma):
            g_rep = jnp.full((r,), gamma)
            state = split_ops.qmc_split_sweep(sl, *state, k1, temp, g_rep, b)
            if global_moves:
                state = split_ops.qmc_split_global(sl, *state, k3, temp, b)
            return state

        def _kin(state):
            return split_ops.qmc_split_kinetic(sl, *state)

        def _permute(state, idx):
            return tuple(x[idx] for x in state)

        def _unpack(state):
            return split_ops.unpack_qmc(sl, *state)
    else:
        state = confs_in

        def _sweep(confs, k1, k3, gamma):
            ks = jax.random.split(k1, r)
            confs = jax.vmap(
                lambda c, kk: piqmc_ops.local_sweep(
                    problem, c, kk, temp, gamma, b
                )
            )(confs, ks)
            if global_moves:
                confs = piqmc_ops.global_line_moves(problem, confs, k3,
                                                    temp, b)
            return confs

        def _kin(confs):
            return jnp.sum(
                confs * jnp.roll(confs, -1, axis=-2), axis=(-1, -2)
            )

        _permute = lambda s, idx: s[idx]  # noqa: E731
        _unpack = lambda s: s  # noqa: E731

    def body(carry, k):
        state, logw, log_z, jp, anc = carry
        k_rs, k1, k3 = jax.random.split(k, 3)
        done = jp >= jp_end

        # whole live step under the cond (see _run_adaptive): padded
        # steps past jp_end cost ~nothing
        def live(args):
            state, logw, log_z, jp, anc = args
            kk = _kin(state).astype(jnp.float32)
            # dlogw = +djp * K / teff: linear in jp, so the classical-PA
            # bisection applies verbatim with e := -K / teff
            djp = _solve_dbeta(logw, -kk / teff,
                               jnp.maximum(jp_end - jp, 0.0), target_ess)
            jp = jp + djp
            logw = logw + djp * kk / teff
            c = logsumexp(logw) - log_r
            log_z = log_z + c
            logw = logw - c
            ess = _ess_of(logw)
            if resample == "systematic":
                idx = _systematic_indices(k_rs, jnp.exp(logw - log_r))
            else:
                idx = jax.random.categorical(k_rs, logw, shape=(r,))
            state = _permute(state, idx)
            anc = anc[idx]
            logw = jnp.zeros_like(logw)
            # Gamma of the new rung: jp = -(teff/2) ln tanh(G/teff)
            # inverts to G = teff * atanh(exp(-2 jp / teff))
            gamma = teff * jnp.arctanh(
                jnp.clip(jnp.exp(-2.0 * jp / teff), 1e-30, 1.0 - 1e-7)
            )
            for i in range(mcsteps):
                state = _sweep(state, jax.random.fold_in(k1, i),
                               jax.random.fold_in(k3, i), gamma)
            return (state, logw, log_z, jp, anc), (jp, ess)

        def dead(args):
            state, logw, log_z, jp, anc = args
            return args, (jp, jnp.float32(r))

        carry, stats = jax.lax.cond(
            done, dead, live, (state, logw, log_z, jp, anc)
        )
        return carry, stats + (done,)

    anc0 = jnp.arange(r, dtype=jnp.int32)
    keys = jax.random.split(key, max_steps)
    (state, logw, log_z, jp, anc), (jps, ess, done) = jax.lax.scan(
        body,
        (state, jnp.zeros((r,), jnp.float32), jnp.float32(0.0),
         jnp.float32(jp0), anc0),
        keys,
    )
    return _unpack(state), log_z, anc, jps, ess, done


def sample_piqmc_adaptive(problem, gamma_start, gamma_end, temp, confs, key,
                          target_frac=0.9, mcsteps=1, max_steps=400, b=1.0,
                          resample="systematic", global_moves=False):
    """Adaptive-step quantum PA: anneal the transverse field from
    gamma_start to gamma_end choosing each step ON-DEVICE so the
    incremental ESS holds `target_frac * R` — the Gamma-space analog of
    sample_adaptive, using that the extended-ensemble reweighting is
    LINEAR in J_perp (dlogw = dJp * K / T_eff), so the same bisection
    applies with e := -K/T_eff, and stepping uniformly in achieved ESS
    rather than in Gamma. J_perp inverts to Gamma in closed form
    (G = T_eff * atanh(exp(-2 Jp / T_eff))) for the sweeps.

    Motivation (bench/pa_value.py, round 5): a FIXED 1000-step Gamma
    grid at benchmark scale collapsed the population (min ESS 0.4%) — the
    kinetic-term spread across replicas makes uniform Gamma steps wildly
    non-uniform in ensemble distance. The adaptive grid is the
    principled schedule; its step count is then an honest measurement of
    how expensive exact extended-ensemble tracking IS at a given size.

    Returns (confs, log_z, stats) with stats = {"jps": traversed J_perp
    grid, "ess": per-step ESS, "n_steps": int, "reached": bool,
    "families": int}.
    """
    slices = confs.shape[-2]
    teff = temp * slices
    jp0 = float(sched_mod.jperp(jnp.float32(gamma_start), teff))
    jp_end = float(sched_mod.jperp(jnp.float32(gamma_end), teff))
    if jp_end < jp0:
        raise ValueError(
            "annealing direction must increase J_perp (decrease Gamma)"
        )
    out, log_z, anc, jps, ess, done = _run_piqmc_adaptive(
        problem, jnp.float32(jp_end), temp, confs, key, int(max_steps),
        int(mcsteps), resample, jnp.float32(target_frac),
        jnp.float32(jp0), b, bool(global_moves),
    )
    done = np.asarray(done)
    n_steps = int((~done).sum())
    stats = {
        "jps": np.asarray(jps)[:n_steps],
        "ess": np.asarray(ess)[:n_steps],
        "n_steps": n_steps,
        "reached": bool(n_steps < int(max_steps)),
        "families": int(np.unique(np.asarray(anc)).size),
    }
    return out, log_z, stats


def merge_populations(states_list, log_zs, key, r_out=None):
    """Resample one combined population from K independent runs, drawing
    each output replica from run k with probability prop. to exp(log_z_k)
    and uniformly within the run (valid for equally-weighted final
    populations, i.e. ess_threshold=1.0 runs). Family diversity adds
    across runs — K collapsed runs still contribute up to K families.

    Returns (states (r_out, N), run_of (r_out,) int32 source-run ids).
    """
    k = len(states_list)
    r = states_list[0].shape[0]
    if r_out is None:
        r_out = r
    w = np.asarray(combine_runs(log_zs)["weights"], dtype=np.float32)
    k_run, k_rep = jax.random.split(key)
    run_of = jax.random.choice(
        k_run, k, shape=(r_out,), p=jnp.asarray(w)
    ).astype(jnp.int32)
    rep_of = jax.random.randint(k_rep, (r_out,), 0, r)
    stacked = jnp.stack(states_list)  # (K, R, N)
    return stacked[run_of, rep_of], run_of
