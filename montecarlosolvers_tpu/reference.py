"""Plain references the engines are checked against, shared by the test
suite and chip_smoke.py.

* Sequential NumPy oracles: the reference kernels' defining update rules
  (one spin at a time, Fisher-Yates-shuffled order, immediately visible
  updates; sa.pyx:71-99, qmc.pyx:97-143 and 405-438, svmc.pyx:92-117),
  vectorized over independent repetitions.
* float64 NumPy energies of ±1 samples from `i j J_ij` triplets.
* Exact enumeration of small systems and the empirical state histogram
  of a jitted update, for exact-Gibbs checks.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu import schedules


# --------------------------------------------------------------------------
# Sequential oracles (reference semantics, vectorized over reps)
# --------------------------------------------------------------------------

def metropolis(de, temp, u):
    """Reference accept rule on a batch: de <= 0, else u < exp(-de/T)
    (sa.pyx:96-99). temp == 0 accepts downhill only."""
    if temp <= 0:
        return de <= 0.0
    return (de <= 0.0) | (u < np.exp(np.minimum(-de / temp, 0.0)))


def sequential_anneal(rng, s, nbr_idx, nbr_J, h, sched):
    """sa.Anneal semantics (sa.pyx:71-99): per temperature, one sweep of
    single-spin Metropolis in a fresh per-rep random permutation, updates
    applied immediately. s: (reps, N), modified in place."""
    reps, n = s.shape
    r_ix = np.arange(reps)
    for temp in sched:
        orders = np.argsort(rng.random((reps, n)), axis=1)
        u = rng.random((reps, n))
        for t in range(n):
            i = orders[:, t]
            sv = s[r_ix[:, None], nbr_idx[i]]
            field = np.einsum("rm,rm->r", nbr_J[i], sv) + h[i]
            si = s[r_ix, i]
            de = -2.0 * si * field
            acc = metropolis(de, temp, u[:, t])
            s[r_ix, i] = np.where(acc, -si, si)
    return s


def sequential_piqmc_anneal(rng, confs, nbr_idx, nbr_J, h, a_sched, b_sched,
                            temp, collect=None):
    """qmc.QuantumAnnealGlobal semantics (qmc.pyx:97-143, 405-438): per
    schedule step, per slice in order, single-spin Metropolis in a fresh
    per-rep permutation with immediately-visible updates (intra-slice +
    periodic Trotter-ring dE at T_eff = P*T), then sequential whole-line
    flips whose dE sums intra-slice terms only (J_perp cancels).
    confs: (reps, P, N), modified in place. `collect(confs)` is called
    after every schedule step when given (equilibrium tails)."""
    reps, P, n = confs.shape
    teff = temp * P
    r_ix = np.arange(reps)
    p_ix = np.arange(P)
    for gamma, B in zip(a_sched, b_sched):
        jp = -(teff / 2.0) * np.log(np.tanh(gamma / teff))
        for k in range(P):
            up, dn = (k - 1) % P, (k + 1) % P
            orders = np.argsort(rng.random((reps, n)), axis=1)
            u = rng.random((reps, n))
            for t in range(n):
                i = orders[:, t]
                sv = confs[r_ix[:, None], k, nbr_idx[i]]
                field = np.einsum("rm,rm->r", nbr_J[i], sv) + h[i]
                si = confs[r_ix, k, i]
                tr = confs[r_ix, up, i] + confs[r_ix, dn, i]
                de = -2.0 * B * si * field + 2.0 * jp * si * tr
                acc = metropolis(de, teff, u[:, t])
                confs[r_ix, k, i] = np.where(acc, -si, si)
        orders = np.argsort(rng.random((reps, n)), axis=1)
        u = rng.random((reps, n))
        for t in range(n):
            i = orders[:, t]
            sv = confs[
                r_ix[:, None, None], p_ix[None, :, None],
                nbr_idx[i][:, None, :],
            ]  # (reps, P, maxnb)
            fields = np.einsum("rm,rpm->rp", nbr_J[i], sv) + h[i][:, None]
            line = confs[r_ix, :, i]  # (reps, P)
            de = -2.0 * B * np.einsum("rp,rp->r", line, fields)
            acc = metropolis(de, teff, u[:, t])
            confs[r_ix[:, None], p_ix[None, :], i[:, None]] = np.where(
                acc[:, None], -line, line
            )
        if collect is not None:
            collect(confs)
    return confs


def sequential_svmc_anneal(rng, theta, nbr_idx, nbr_J, h, a_sched, b_sched,
                           temp):
    """svmc.SpinVectorMonteCarlo semantics (svmc.pyx:92-117): per schedule
    step, single-rotor Metropolis in a fresh per-rep permutation with
    immediate updates — theta' = pi*u proposal, cosine z-fields, sine
    transverse term, fixed-T accept. theta: (reps, N), in place."""
    reps, n = theta.shape
    r_ix = np.arange(reps)
    for a, B in zip(a_sched, b_sched):
        orders = np.argsort(rng.random((reps, n)), axis=1)
        u_prop = rng.random((reps, n))
        u_acc = rng.random((reps, n))
        for t in range(n):
            i = orders[:, t]
            prop = np.pi * u_prop[:, t]
            cos_nb = np.cos(theta[r_ix[:, None], nbr_idx[i]])
            zfield = np.einsum("rm,rm->r", nbr_J[i], cos_nb) + h[i]
            th_i = theta[r_ix, i]
            de = (
                B * (np.cos(prop) - np.cos(th_i)) * zfield
                + a * (np.sin(th_i) - np.sin(prop))
            )
            acc = metropolis(de, temp, u_acc[:, t])
            theta[r_ix, i] = np.where(acc, prop, th_i)
    return theta


def transient_gap(e_seq, e_ours, rel_tol=5e-3):
    """Equal-sweep anneal transients of two correct kernels agree within
    max(3 sigma, rel_tol * |mean|): their finite-time laws need not
    coincide exactly (see tests/test_reference_equivalence.py). Returns
    (|mean difference|, bound, std ratio); the std ratio must lie in
    (0.4, 2.5)."""
    m1, m2 = e_seq.mean(), e_ours.mean()
    se = np.sqrt(e_seq.var() / e_seq.size + e_ours.var() / e_ours.size)
    bound = max(3.0 * se, rel_tol * abs(m1))
    return abs(m1 - m2), bound, e_seq.std() / max(e_ours.std(), 1e-9)


# --------------------------------------------------------------------------
# float64 energies
# --------------------------------------------------------------------------

def triplet_energy(samples, rows, cols, vals):
    """float64 H(s) = sum_(i<j) J_ij s_i s_j + sum_i h_i s_i of ±1 samples
    (..., N) from 0-indexed triplets (diagonal entries are fields) — the
    convention of IsingProblem / LatticeProblem and
    models.classical_ising_energy."""
    s = np.asarray(samples, np.float64)
    rows, cols = np.asarray(rows), np.asarray(cols)
    vals = np.asarray(vals, np.float64)
    off = rows != cols
    e = np.sum(vals[off] * s[..., rows[off]] * s[..., cols[off]], axis=-1)
    return e + np.sum(vals[~off] * s[..., rows[~off]], axis=-1)


def dense_energy(samples, J, h):
    """float64 H(s) = 1/2 s J s + h s of a DenseProblem's couplings."""
    s = np.asarray(samples, np.float64)
    J = np.asarray(J, np.float64)
    return 0.5 * np.einsum("...n,nm,...m->...", s, J, s) + s @ np.asarray(
        h, np.float64)


# --------------------------------------------------------------------------
# Exact enumeration
# --------------------------------------------------------------------------

def extended_energy(prob, confs, temp, gamma, b=1.0, lookuptable=None):
    """Total PIQMC Hamiltonian consistent with the kernel dE conventions
    (qmc.pyx:114-143, 269-273):
    E = B sum_k E_slice(k) - jperp sum_k s_k s_{k+1} - (teff/2) s L s."""
    from montecarlosolvers_tpu.ops import piqmc as piqmc_ops

    slices = confs.shape[-2]
    teff = temp * slices
    jp = schedules.jperp(gamma, teff)
    e = b * jnp.sum(prob.energy(confs), axis=-1)
    e = e - jp * jnp.sum(confs * jnp.roll(confs, -1, axis=-2), axis=(-1, -2))
    if lookuptable is not None:
        L = piqmc_ops.bath_matrix(lookuptable, slices)
        e = e - 0.5 * teff * jnp.einsum("...pn,pq,...qn->...", confs, L, confs)
    return e


def enumerate_states(nspins, slices):
    """All 2^(nspins*slices) ±1 configurations, shape (S, slices, nspins);
    state index = sum of 2^i over the positive sites (row-major)."""
    n = nspins * slices
    bits = (np.arange(1 << n)[:, None] >> np.arange(n)) & 1
    return jnp.asarray(
        (bits * 2 - 1).reshape(-1, slices, nspins).astype(np.float32))


def state_histogram(run_step, confs0, key, nsteps, burn):
    """Empirical distribution over the enumerated states of `nsteps`
    scanned applications of `run_step(confs, key)` to a (chains, ...)
    batch, dropping the first `burn` steps; indexes match
    `enumerate_states`."""
    n = int(np.prod(confs0.shape[1:]))
    weights = jnp.asarray([1 << i for i in range(n)])

    @jax.jit
    def run(confs, key):
        def body(c, k):
            c = run_step(c, k)
            bits = (c > 0).astype(jnp.int32).reshape(c.shape[0], n)
            return c, bits @ weights

        return jax.lax.scan(body, confs, jax.random.split(key, nsteps))[1]

    idxs = np.asarray(run(confs0, key))[burn:]
    counts = np.bincount(idxs.ravel(), minlength=1 << n)
    return counts / counts.sum()
