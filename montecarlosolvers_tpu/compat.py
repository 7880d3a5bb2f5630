"""Drop-in compatibility layer: the reference's exact API surface.

Every public kernel of the reference (SURVEY.md §2.1 #1-22) under its
original name and signature, including the reference's conventions:

  * neighbor tables in the (nspins, maxnb, 2) format of
    tools.GenerateNeighbors (tools.pyx:28-96), diagonal self-entries as
    local fields;
  * states mutated IN PLACE (sa.pyx:44-46) — the passed NumPy array holds
    the result;
  * confs in the reference's spins-major (nspins, P) layout (qmc.pyx:69).

`seed`/`rng` arguments: functions accept an optional integer seed or a
numpy Generator/RandomState in place of the reference's implicit libc
stream; omitted means a fresh nondeterministic seed.

Under the hood everything runs on the JAX solvers — colored
parallel sweeps, counter-based RNG (statistically equivalent samplers;
see solvers/ and ops/cluster.py docstrings for documented deviations).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models.ising import (
    IsingProblem,
    generate_neighbors as GenerateNeighbors,  # noqa: N812  (reference name)
    classical_ising_energy as ClassicalIsingEnergy,  # noqa: N812
    bits2spins,
    spins2bits,
)
from montecarlosolvers_tpu.solvers import sa as _sa
from montecarlosolvers_tpu.solvers import qmc as _qmc
from montecarlosolvers_tpu.solvers import svmc as _svmc

__all__ = [
    "GenerateNeighbors", "ClassicalIsingEnergy", "bits2spins", "spins2bits",
    "Anneal", "AnnealMA", "Anneal_parallel", "NoisyAnneal",
    "QuantumAnneal", "DissipativeQuantumAnneal", "QuantumAnnealGlobal",
    "DissipativeQuantumAnnealGlobal", "QuantumAnnealWCL",
    "DissaptiveQuantumAnnealWCL", "QuantumAnnealWC",
    "DissipativeQuantumAnnealWC2", "DissipativeQuantumAnnealWC3",
    "SpinVectorMonteCarlo", "SpinVectorMonteCarloTF", "NoisySVMC",
    "NoisySVMCTF", "SpinVectorMonteCarloCompact",
    "SpinVectorMonteCarloTFCompact",
]

import collections
import hashlib

_problem_cache = collections.OrderedDict()
_PROBLEM_CACHE_MAX = 32


def _key(seed):
    if seed is None:
        seed = np.random.SeedSequence().entropy % (2 ** 63)
    elif isinstance(seed, (np.random.Generator, np.random.RandomState)):
        seed = int(
            seed.integers(2 ** 63) if isinstance(seed, np.random.Generator)
            else seed.randint(2 ** 31)
        )
    return jax.random.key(int(seed))


def _problem(nbs):
    nbs = np.asarray(nbs)
    digest = hashlib.sha1(nbs.tobytes()).digest()
    prob = _problem_cache.get(digest)
    if prob is None:
        prob = IsingProblem.from_neighbor_table(nbs)
        _problem_cache[digest] = prob
        while len(_problem_cache) > _PROBLEM_CACHE_MAX:
            _problem_cache.popitem(last=False)
    else:
        _problem_cache.move_to_end(digest)
    return prob


def _split_noisy(nbs4d):
    """(S, N, maxnb, 2) time-dependent table -> problem + per-step
    (S, N, maxnb) couplings and (S, N) fields.

    The coloring/padding topology is built from the UNION of slots active
    at any schedule step (max |J| over time): a coupling that is zero at
    step 0 but ramps up later (noise/control trajectories, the advertised
    use case of sa.NoisyAnneal) must still count as an edge, or two
    interacting spins could share a color class.
    """
    nbs4d = np.asarray(nbs4d)
    idx = nbs4d[:, :, :, 0].astype(np.int64)
    val = nbs4d[:, :, :, 1]
    topo = nbs4d[0].copy()
    topo[:, :, 1] = np.abs(val).max(axis=0)
    prob = _problem(topo)
    own = np.arange(nbs4d.shape[1])[None, :, None]
    is_self = idx == own
    h_t = np.where(is_self, val, 0.0).sum(axis=2)
    j_t = np.where(is_self, 0.0, val)
    return prob, jnp.asarray(j_t, jnp.float32), jnp.asarray(h_t, jnp.float32)


# ----------------------------------------------------------------- sa.pyx
def Anneal(sched, mcsteps, svec, nbs, seed=None):
    """sa.Anneal (sa.pyx:19-101): thermal anneal, svec updated in place."""
    prob = _problem(nbs)
    out = _sa.anneal(
        prob, jnp.asarray(np.asarray(sched, np.float32)),
        jnp.asarray(np.asarray(svec, np.float32)), _key(seed),
        mcsteps=int(mcsteps),
    )
    svec[:] = np.asarray(out).astype(svec.dtype)


def AnnealMA(sched, mcsteps, svec, nbs, seed=None):
    """sa.AnnealMA (sa.pyx:108-193): identical sampler; the pre-drawn
    uniform streams are subsumed by the deterministic key."""
    Anneal(sched, mcsteps, svec, nbs, seed=seed)


def Anneal_parallel(sched, mcsteps, svec, nbs, nthreads=None, seed=None):
    """sa.Anneal_parallel (sa.pyx:201-284). nthreads is ignored — the
    colored sweep is exactly parallel (race-free), and trajectory
    parallelism is a batch axis on the native API."""
    Anneal(sched, mcsteps, svec, nbs, seed=seed)


def NoisyAnneal(sched, mcsteps, svec, nbs, seed=None):
    """sa.NoisyAnneal (sa.pyx:291-378): 4-D time-dependent neighbor table,
    first axis indexed by schedule step."""
    prob, j_t, h_t = _split_noisy(nbs)
    out = _sa.anneal_noisy(
        prob, jnp.asarray(np.asarray(sched, np.float32)), j_t, h_t,
        jnp.asarray(np.asarray(svec, np.float32)), _key(seed),
        mcsteps=int(mcsteps),
    )
    svec[:] = np.asarray(out).astype(svec.dtype)


# ---------------------------------------------------------------- qmc.pyx
def _qmc_call(fn, confs, **kw):
    """Run a (P, N)-layout solver on reference (N, P)-layout confs."""
    c = jnp.asarray(np.asarray(confs, np.float32).T)
    out = fn(confs=c, **kw)
    confs[:] = np.asarray(out).T.astype(confs.dtype)


def QuantumAnneal(A_sched, B_sched, mcsteps, temp, confs, nbs, nthreads=None,
                  seed=None):
    """qmc.QuantumAnneal (qmc.pyx:25-143): PIQMC, local moves only."""
    _qmc_call(
        lambda confs: _qmc.anneal(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps),
        ),
        confs,
    )


def DissipativeQuantumAnneal(A_sched, B_sched, mcsteps, temp, lookuptable,
                             confs, nbs, nthreads=None, seed=None):
    """qmc.DissipativeQuantumAnneal (qmc.pyx:149-278): + system-bath term."""
    _qmc_call(
        lambda confs: _qmc.anneal(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps),
            lookuptable=jnp.asarray(np.asarray(lookuptable, np.float32)),
        ),
        confs,
    )


def QuantumAnnealGlobal(A_sched, B_sched, mcsteps, temp, confs, nbs,
                        nthreads=None, seed=None):
    """qmc.QuantumAnnealGlobal (qmc.pyx:284-438): + whole-line moves."""
    _qmc_call(
        lambda confs: _qmc.anneal(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps), global_moves=True,
        ),
        confs,
    )


def DissipativeQuantumAnnealGlobal(A_sched, B_sched, mcsteps, temp,
                                   lookuptable, confs, nbs, nthreads=None,
                                   seed=None):
    """qmc.DissipativeQuantumAnnealGlobal (qmc.pyx:444-609)."""
    _qmc_call(
        lambda confs: _qmc.anneal(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps), global_moves=True,
            lookuptable=jnp.asarray(np.asarray(lookuptable, np.float32)),
        ),
        confs,
    )


def QuantumAnnealWCL(A_sched, B_sched, mcsteps, temp, confs, nbs, seed=None):
    """qmc.QuantumAnnealWCL (qmc.pyx:620-786): Wolff clusters, pair-energy
    bond rule."""
    _qmc_call(
        lambda confs: _qmc.anneal_wolff(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps), rule="local",
        ),
        confs,
    )


def DissaptiveQuantumAnnealWCL(A_sched, B_sched, mcsteps, temp, lookuptable,
                               confs, nbs, seed=None):
    """qmc.DissaptiveQuantumAnnealWCL [sic] (qmc.pyx:792-1000): Wolff with
    bath bonds (the reference's typo'd name is preserved)."""
    _qmc_call(
        lambda confs: _qmc.anneal_wolff(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps), rule="local",
            lookuptable=jnp.asarray(np.asarray(lookuptable, np.float32)),
        ),
        confs,
    )


def QuantumAnnealWC(A_sched, B_sched, mcsteps, temp, confs, nbs, seed=None):
    """qmc.QuantumAnnealWC (qmc.pyx:1006-1225): full-local-energy bond rule."""
    _qmc_call(
        lambda confs: _qmc.anneal_wolff(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), confs,
            _key(seed), mcsteps=int(mcsteps), rule="full",
        ),
        confs,
    )


def DissipativeQuantumAnnealWC2(A_sched, B_sched, mcsteps, temp, lookuptable,
                                confs, nbs, nthreads=None, seed=None):
    """qmc.DissipativeQuantumAnnealWC2 (qmc.pyx:1231-1446): local sweeps +
    SW bath clusters, random seed slice per spin. The reference's inverted
    accept test and bath-index slip are fixed, not replicated."""
    _qmc_call(
        lambda confs: _qmc.anneal_sw_bath(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp),
            jnp.asarray(np.asarray(lookuptable, np.float32)), confs,
            _key(seed), mcsteps=int(mcsteps), per_slice_seeds=False,
        ),
        confs,
    )


def DissipativeQuantumAnnealWC3(A_sched, B_sched, mcsteps, temp, lookuptable,
                                confs, nbs, nthreads=None, seed=None):
    """qmc.DissipativeQuantumAnnealWC3 (qmc.pyx:1452-1621): SW bath
    clusters seeded at every (slice, spin)."""
    _qmc_call(
        lambda confs: _qmc.anneal_sw_bath(
            _problem(nbs), jnp.asarray(np.asarray(A_sched, np.float32)),
            jnp.asarray(np.asarray(B_sched, np.float32)), float(temp),
            jnp.asarray(np.asarray(lookuptable, np.float32)), confs,
            _key(seed), mcsteps=int(mcsteps), per_slice_seeds=True,
        ),
        confs,
    )


# --------------------------------------------------------------- svmc.pyx
def _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, tf, seed):
    prob = _problem(nbs)
    out = _svmc.anneal(
        prob, jnp.asarray(np.asarray(A_sched, np.float32)),
        jnp.asarray(np.asarray(B_sched, np.float32)), float(temp),
        jnp.asarray(np.asarray(svec, np.float32)), _key(seed),
        mcsteps=int(mcsteps), tf=tf,
    )
    svec[:] = np.asarray(out).astype(svec.dtype)


def SpinVectorMonteCarlo(A_sched, B_sched, mcsteps, temp, svec, nbs,
                         seed=None):
    """svmc.SpinVectorMonteCarlo (svmc.pyx:21-117): angles in [0, pi]."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, False, seed)


def SpinVectorMonteCarloTF(A_sched, B_sched, mcsteps, temp, svec, nbs,
                           seed=None):
    """svmc.SpinVectorMonteCarloTF (svmc.pyx:123-229): TF proposals."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, True, seed)


def _noisy_svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs4d, tf, seed):
    prob, j_t, h_t = _split_noisy(nbs4d)
    out = _svmc.anneal_noisy(
        prob, jnp.asarray(np.asarray(A_sched, np.float32)),
        jnp.asarray(np.asarray(B_sched, np.float32)), float(temp), j_t, h_t,
        jnp.asarray(np.asarray(svec, np.float32)), _key(seed),
        mcsteps=int(mcsteps), tf=tf,
    )
    svec[:] = np.asarray(out).astype(svec.dtype)


def NoisySVMC(A_sched, B_sched, mcsteps, temp, svec, nbs, seed=None):
    """svmc.NoisySVMC (svmc.pyx:236-334): 4-D time-dependent couplings."""
    _noisy_svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, False, seed)


def NoisySVMCTF(A_sched, B_sched, mcsteps, temp, svec, nbs, seed=None):
    """svmc.NoisySVMCTF (svmc.pyx:340-448)."""
    _noisy_svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, True, seed)


def SpinVectorMonteCarloCompact(A_sched, B_sched, mcsteps, temp, svec, nbs,
                                seed=None):
    """svmc.SpinVectorMonteCarloCompact (svmc.pyx:455-554): svec is
    (numreads, nspins); reads are a batch axis here (the reference loops
    them serially, svmc.pyx:514)."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, False, seed)


def SpinVectorMonteCarloTFCompact(A_sched, B_sched, mcsteps, temp, svec, nbs,
                                  nthreads=None, seed=None):
    """svmc.SpinVectorMonteCarloTFCompact (svmc.pyx:561-674): the
    reference's 6-thread OpenMP read loop (svmc.pyx:624) is a batch axis."""
    _svmc_run(A_sched, B_sched, mcsteps, temp, svec, nbs, True, seed)
