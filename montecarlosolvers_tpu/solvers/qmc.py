"""Path-integral quantum Monte Carlo annealing — the JAX analog of qmc.pyx.

Capability map to the reference kernel inventory (SURVEY.md §2.1 #5-13):

  anneal(..., global_moves=False)                 <- qmc.QuantumAnneal
  anneal(..., global_moves=True)                  <- qmc.QuantumAnnealGlobal
  anneal(..., lookuptable=...)                    <- qmc.DissipativeQuantumAnneal
  anneal(..., lookuptable=..., global_moves=True) <- qmc.DissipativeQuantumAnnealGlobal
  anneal_wolff(rule="local")                      <- qmc.QuantumAnnealWCL
  anneal_wolff(rule="local", lookuptable=...)     <- qmc.DissaptiveQuantumAnnealWCL [sic]
  anneal_wolff(rule="full")                       <- qmc.QuantumAnnealWC
  anneal_sw_bath(per_slice_seeds=False)           <- qmc.DissipativeQuantumAnnealWC2
  anneal_sw_bath(per_slice_seeds=True)            <- qmc.DissipativeQuantumAnnealWC3

State layout is slices-major: confs (..., P, N) — the transpose of the
reference's (nspins, P) (qmc.pyx:69-70); N is the fast axis for VPU lanes.
Use `replicate` to build the initial Trotter state from a pre-annealed
classical state (examples/santoro80.py:286).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu import schedules as sched_mod

# Default max sweeps per device dispatch (schedules.segments): a very long
# anneal runs as several bounded dispatches, each shipping only its own
# schedule window. bench/mst.py pads schedules against this
# (schedules.pad_schedule) to bucket compile shapes.
SEGMENT = 25_000
from montecarlosolvers_tpu.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu.ops import cluster as cluster_ops


def replicate(spins, slices):
    """Tile a classical state into P Trotter replicas: (..., N) -> (..., P, N)
    (examples/santoro80.py:286, transposed to slices-major)."""
    return jnp.broadcast_to(
        spins[..., None, :], spins.shape[:-1] + (slices, spins.shape[-1])
    ).copy()


def slice_energies(problem, confs):
    """Classical Ising energy of every Trotter slice: (..., P)."""
    return problem.energy(confs)


def best_slice_energy(problem, confs):
    """min over slices of the classical energy — the benchmark readout
    (examples/santoro80.py:290-296)."""
    return jnp.min(problem.energy(confs), axis=-1)


def anneal(problem, a_sched, b_sched, temp, confs, key, mcsteps=1,
           global_moves=False, lookuptable=None, collect_energy=False,
           bath_update="sequential", segment=SEGMENT):
    """PIQMC anneal over the transverse-field schedule.

    Args:
      problem: IsingProblem.
      a_sched: (schedsize,) transverse field Gamma values (end > 0, e.g.
        1e-8, to keep J_perp finite — examples/santoro80.py:274).
      b_sched: (schedsize,) longitudinal scale B (identically 1 in the
        benchmark, examples/santoro80.py:282).
      temp: ambient temperature T; the effective slice temperature is
        T_eff = P*T (qmc.pyx:85).
      confs: (..., P, N) float32 +/-1 Trotter state, slices-major.
      mcsteps: sweeps per schedule step.
      global_moves: add whole-line flips after each sweep
        (QuantumAnnealGlobal, qmc.pyx:405-438).
      lookuptable: optional (P-1,) system-bath couplings
        (schedules.bath_lookuptable) — switches local sweeps to the
        dissipative slice-sequential kernel (qmc.pyx:149-278).
      collect_energy: emit per-step best-slice energies.
      bath_update: "sequential" (default) — the reference's exact
        slice-sequential bath sweep; "colored" — the approximate
        snapshot-bath colored sweep with no sequential slice loop
        (ops/piqmc.dissipative_colored_sweep for the validated bias
        bounds). Ignored without a lookuptable.
      segment: max sweeps per device dispatch (schedules.segments) — a
        tau=6e6 anneal runs as ONE call made of bounded dispatches.
        One-segment schedules keep the unfolded key (bitwise-identical to
        the unsegmented behavior). None disables.

    Returns:
      confs, or (confs, energies) when collect_energy.
    """
    if bath_update not in ("sequential", "colored"):
        raise ValueError(
            f"bath_update must be 'sequential' or 'colored', got "
            f"{bath_update!r}"
        )
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)

    segs = sched_mod.segments(a.shape[0], segment)
    es_parts = []
    for lo, hi in segs:
        k = key if len(segs) == 1 else jax.random.fold_in(key, lo)
        out = _anneal_segment(
            problem, a[lo:hi], b[lo:hi], temp, confs, k,
            global_moves=global_moves, lookuptable=lookuptable,
            collect_energy=collect_energy, bath_update=bath_update,
        )
        confs, es = out if collect_energy else (out, None)
        if collect_energy:
            es_parts.append(es)
    if collect_energy:
        es = es_parts[0] if len(es_parts) == 1 else jnp.concatenate(es_parts)
        return confs, es
    return confs


@partial(
    jax.jit,
    static_argnames=("global_moves", "collect_energy", "bath_update"),
)
def _anneal_segment(problem, a, b, temp, confs, key, global_moves=False,
                    lookuptable=None, collect_energy=False,
                    bath_update="sequential"):
    """One jitted dispatch of `anneal` over a pre-expanded schedule slice."""
    from montecarlosolvers_tpu.ops import split as split_ops

    slices = confs.shape[-2]
    if split_ops.supports_split(problem, slices):
        # even-L lattice, even P: split-checkerboard engine (ops/split.py)
        # — maskless phase-set updates, half-volume global line moves,
        # zero lane padding at benchmark shape. The dissipative form keeps
        # the reference's slice-sequential order but runs each slice as
        # two maskless half-phases (qmc_bath_anneal_split).
        if lookuptable is None:
            confs, es = split_ops.qmc_anneal_split(
                problem, a, b, temp, confs, key,
                global_moves=global_moves, collect_energy=collect_energy,
            )
        else:
            confs, es = split_ops.qmc_bath_anneal_split(
                problem, a, b, temp, confs, key, lookuptable,
                global_moves=global_moves, collect_energy=collect_energy,
                bath_update=bath_update,
            )
        if collect_energy:
            return confs, es
        return confs

    keys = jax.random.split(key, a.shape[0])
    bath_mat = (
        piqmc_ops.bath_matrix(lookuptable, slices) if lookuptable is not None else None
    )

    def body(confs, x):
        gamma, bcur, k = x
        k1, k2 = jax.random.split(k)
        if lookuptable is not None:
            if bath_update == "colored":
                confs = piqmc_ops.dissipative_colored_sweep(
                    problem, confs, k1, temp, gamma, bcur, bath_mat
                )
            else:
                confs = piqmc_ops.dissipative_local_sweep(
                    problem, confs, k1, temp, gamma, bcur, bath_mat
                )
        else:
            confs = piqmc_ops.local_sweep(
                problem, confs, k1, temp, gamma, bcur
            )
        if global_moves:
            confs = piqmc_ops.global_line_moves(problem, confs, k2, temp, bcur)
        out = best_slice_energy(problem, confs) if collect_energy else None
        return confs, out

    confs, es = jax.lax.scan(body, confs, (a, b, keys))
    if collect_energy:
        return confs, es
    return confs


def anneal_wolff(problem, a_sched, b_sched, temp, confs, key, mcsteps=1,
                 rule="local", lookuptable=None):
    """PIQMC anneal with Wolff cluster updates (one cluster per MC step,
    matching the reference's step semantics at qmc.pyx:693-697).

    rule="local": pair-energy bond rule (QuantumAnnealWCL). With a
      `lookuptable`, bath bonds join the growth (DissaptiveQuantumAnnealWCL;
      implemented as additional imaginary-time bonds in the same draw).
    rule="full": full-local-energy bond rule (QuantumAnnealWC).

    LatticeProblems are converted to the padded-gather representation
    (the cluster engine walks explicit neighbor tables)."""
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    if lookuptable is not None:
        # The bath bond draw materializes ~3 live (N, P, P) f32 tensors
        # per chain (ops/cluster.py wolff_update docstring); catch an
        # obvious OOM before XLA fails with an opaque allocation error.
        chains = int(np.prod(confs.shape[:-2])) if confs.ndim > 2 else 1
        slices = confs.shape[-2]
        est = 3 * 4 * chains * problem.nspins * slices * slices
        if est > 8 << 30:
            raise ValueError(
                f"dissipative Wolff bath draw needs ~{est / 2**30:.1f} GiB "
                f"of (chains={chains}, N={problem.nspins}, P={slices}) "
                "imaginary-time bond tensors — reduce the chain batch "
                "(e.g. <= 8 chains at N=6400, P=40) or shard chains "
                "across devices (parallel/mesh.py)."
            )
    return _anneal_wolff_impl(
        problem, a_sched, b_sched, temp, confs, key, mcsteps=mcsteps,
        rule=rule, lookuptable=lookuptable,
    )


@partial(jax.jit, static_argnames=("mcsteps", "rule"))
def _anneal_wolff_impl(problem, a_sched, b_sched, temp, confs, key, mcsteps=1,
                       rule="local", lookuptable=None):
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])

    batched = confs.ndim > 2
    upd = partial(cluster_ops.wolff_update, rule=rule, lookuptable=lookuptable)
    if batched:
        updv = jax.vmap(upd, in_axes=(None, 0, 0, None, None, None), out_axes=0)

    def body(confs, x):
        gamma, bcur, k = x
        if batched:
            ks = jax.random.split(k, confs.shape[0])
            confs = updv(problem, confs, ks, temp, gamma, bcur)
        else:
            confs = upd(problem, confs, k, temp, gamma, bcur)
        return confs, None

    confs, _ = jax.lax.scan(body, confs, (a, b, keys))
    return confs


def anneal_sw(problem, a_sched, b_sched, temp, confs, key, mcsteps=1,
              lookuptable=None, local_sweeps=False):
    """PIQMC anneal with FULL space-time Swendsen-Wang sweeps — every FK
    cluster of the (P, N) extended system updates each step for the cost
    of one Wolff cluster's growth (ops/cluster.spacetime_sw_sweep).

    Beyond-reference: the reference flips one cluster per step
    (qmc.pyx:693-697) and only decomposes bath LINES into clusters
    (anneal_sw_bath / WC2-WC3, qmc.pyx:1231-1621); this is the global
    SW decomposition of the whole space-time graph (spatial + Trotter +
    optional bath bonds). Exact extended-Gibbs sampling, histogram-tested.

    local_sweeps=True interleaves a local colored sweep before each SW
    sweep. LatticeProblems are converted to the neighbor-table form.
    """
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    if isinstance(problem, LatticeProblem):
        problem = problem.to_generic()
    if lookuptable is not None:
        # same (N, P, P) bath bond tensors as the dissipative Wolff draw
        chains = int(np.prod(confs.shape[:-2])) if confs.ndim > 2 else 1
        slices = confs.shape[-2]
        est = 3 * 4 * chains * problem.nspins * slices * slices
        if est > 8 << 30:
            raise ValueError(
                f"space-time SW bath draw needs ~{est / 2**30:.1f} GiB of "
                f"(chains={chains}, N={problem.nspins}, P={slices}) bond "
                "tensors — reduce the chain batch or shard chains "
                "(parallel/mesh.py)."
            )
    return _anneal_sw_impl(problem, a_sched, b_sched, temp, confs, key,
                           mcsteps=mcsteps, lookuptable=lookuptable,
                           local_sweeps=local_sweeps)


@partial(jax.jit, static_argnames=("mcsteps", "local_sweeps"))
def _anneal_sw_impl(problem, a_sched, b_sched, temp, confs, key, mcsteps=1,
                    lookuptable=None, local_sweeps=False):
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])

    batched = confs.ndim > 2
    upd = partial(cluster_ops.spacetime_sw_sweep, lookuptable=lookuptable)
    if batched:
        updv = jax.vmap(upd, in_axes=(None, 0, 0, None, None, None),
                        out_axes=0)

    def body(confs, x):
        gamma, bcur, k = x
        k1, k2 = jax.random.split(k)
        if local_sweeps:
            confs = piqmc_ops.local_sweep(problem, confs, k1, temp, gamma,
                                          bcur)
        if batched:
            ks = jax.random.split(k2, confs.shape[0])
            confs = updv(problem, confs, ks, temp, gamma, bcur)
        else:
            confs = upd(problem, confs, k2, temp, gamma, bcur)
        return confs, None

    confs, _ = jax.lax.scan(body, confs, (a, b, keys))
    return confs


@partial(jax.jit, static_argnames=("mcsteps", "per_slice_seeds", "local_sweeps"))
def anneal_sw_bath(problem, a_sched, b_sched, temp, lookuptable, confs, key,
                   mcsteps=1, per_slice_seeds=True, local_sweeps=True):
    """Dissipative anneal with Swendsen-Wang-style bath-bond clusters along
    imaginary time (WC2/WC3 family, qmc.pyx:1231-1621).

    per_slice_seeds=True  -> WC3 analog: a full Swendsen-Wang line
      decomposition (bath + Trotter bonds in the FK draw) updates every
      cluster of every line per phase (ops/cluster.sw_full_phase) —
      subsumes the reference's every-slice-seeds-in-turn loop
      (qmc.pyx:1546) at 1/P the cost.
    per_slice_seeds=False -> WC2: one random seed slice per spin; when
      `local_sweeps` a dissipative local sweep precedes the cluster phase
      (qmc.pyx:1326-1376).
    """
    a = sched_mod.expand_mcsteps(a_sched, mcsteps)
    b = sched_mod.expand_mcsteps(b_sched, mcsteps)
    keys = jax.random.split(key, a.shape[0])

    slices = confs.shape[-2]
    bath_mat = piqmc_ops.bath_matrix(lookuptable, slices)

    sweep = cluster_ops.sw_bath_sweep
    batched = confs.ndim > 2
    if batched:
        sweep = jax.vmap(
            partial(cluster_ops.sw_bath_sweep, per_slice_seeds=per_slice_seeds),
            in_axes=(None, 0, 0, None, None, None, None),
            out_axes=0,
        )

    def body(confs, x):
        gamma, bcur, k = x
        k1, k2 = jax.random.split(k)
        if local_sweeps and not per_slice_seeds:
            confs = piqmc_ops.dissipative_local_sweep(
                problem, confs, k1, temp, gamma, bcur, bath_mat
            )
        if batched:
            ks = jax.random.split(k2, confs.shape[0])
            confs = sweep(problem, confs, ks, temp, gamma, bcur, lookuptable)
        else:
            confs = cluster_ops.sw_bath_sweep(
                problem, confs, k2, temp, gamma, bcur, lookuptable,
                per_slice_seeds=per_slice_seeds,
            )
        return confs, None

    confs, _ = jax.lax.scan(body, confs, (a, b, keys))
    return confs
