"""Multi-process scaling: disorder realizations spread over processes.

The reference runs disorder realizations as separate OS processes on one
machine (SURVEY.md §2.3 — its only backend is shared-memory OpenMP). Here
disorder is a mesh axis: it is embarrassingly parallel (zero collectives
once sharded), so it is the axis that may span processes (hosts), while
the chains axis stays within each process's local devices. One process
drives all the cards of its host; several processes are only needed
across hosts.

Three pieces:

  * `initialize` — thin, idempotent wrapper over `jax.distributed.initialize`.
    Pass coordinator_address / num_processes / process_id explicitly.
  * `dcn_mesh` — a ("disorder", "chains") mesh whose disorder axis spans
    processes and chains axis spans each process's local devices.
    Single-process: reshape the local devices — which is how the virtual
    8-CPU test mesh exercises this exact code path
    (tests/test_parallel.py).
  * `run_disorder_sharded` — stack same-topology problems
    (parallel/disorder.py), shard the coupling leaves + states + keys over
    "disorder" (and states over "chains"), and run the vmapped solver.
    Because every disorder realization is independent, XLA compiles the
    vmapped program SPMD with zero cross-shard communication — results are
    bitwise equal to the unsharded vmap (the same transparency bar as
    chain sharding, tested on the virtual mesh).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from montecarlosolvers_tpu.parallel.disorder import (
    stack_problems,
    vmap_disorder,
)


def initialize(**kwargs):
    """Idempotent `jax.distributed.initialize`. Pass coordinator_address /
    num_processes / process_id explicitly. Returns (process_index,
    process_count)."""
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError:
        # already initialized (or single-process backend that needs no init)
        pass
    return jax.process_index(), jax.process_count()


def dcn_mesh(disorder=None, chains=None, devices=None):
    """A ("disorder", "chains") mesh with disorder across processes and
    chains across each process's local devices.

    Single-process: reshapes `devices` (default all local) into a
    (disorder, chains) grid — the shape the virtual CPU test mesh uses.
    Multi-process: `disorder` must be a multiple of the process count (it
    defaults to exactly the process count, one realization group per
    process); devices are grouped by process, disorder-major, so each
    disorder row is one process's local devices and the only
    cross-process traffic is the (nonexistent) disorder collectives.
    """
    nproc = jax.process_count()
    if nproc > 1:
        local = jax.local_device_count()
        if disorder is None:
            disorder = nproc
        if chains is None:
            chains = (nproc * local) // disorder
        if disorder % nproc:
            raise ValueError(
                f"disorder={disorder} must be a multiple of the process "
                f"count {nproc} so each realization group stays on one host"
            )
        devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
        dev = np.array(devs).reshape(disorder, chains)
        return Mesh(dev, axis_names=("disorder", "chains"))
    devices = np.asarray(devices if devices is not None else jax.devices())
    if disorder is None:
        disorder = devices.size if chains is None else devices.size // chains
    if chains is None:
        chains = devices.size // disorder
    return Mesh(
        devices[: disorder * chains].reshape(disorder, chains),
        axis_names=("disorder", "chains"),
    )


def _gput(x, sharding):
    """device_put that also works on multi-process (non-addressable)
    shardings: every process passes the SAME full host value and
    make_array_from_callback places each process's addressable pieces —
    the standard host-local -> global construction for multi-process
    meshes."""
    try:
        return jax.device_put(x, sharding)
    except ValueError:
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )


def shard_disorder_problem(stacked, mesh):
    """Place a stacked problem's per-realization leaves (nbr_J, h) on the
    "disorder" mesh axis; topology leaves stay replicated."""
    import dataclasses

    def put(x, spec):
        return _gput(x, NamedSharding(mesh, spec))

    return dataclasses.replace(
        stacked,
        nbr_J=put(stacked.nbr_J, P("disorder", None, None)),
        h=put(stacked.h, P("disorder", None)),
        color_masks=put(stacked.color_masks, P()),
        nbr_idx=put(stacked.nbr_idx, P()),
    )


def run_disorder_sharded(solver_fn, problems, sched, states, keys, mesh,
                         extra_args=()):
    """Run `solver_fn(problem, sched, *extra_args, state, key)` over a
    disorder batch, sharded (disorder, chains) over `mesh`.

    problems: list of same-topology IsingProblems (one per realization).
    sched: broadcast schedule array; extra_args: further broadcast args
    between the schedule and the state (vmap_disorder's convention).
    states: (D, C, ..., N) — disorder-major, then the chain batch.
    keys: (D,) typed key array (one stream per realization).

    Returns the solver output with the same (D, C, ...) leading layout,
    bitwise equal to the unsharded `vmap_disorder` run (zero cross-shard
    communication — disorder realizations never interact).
    """
    stacked, axes = stack_problems(problems)
    stacked = shard_disorder_problem(stacked, mesh)
    spec = P("disorder", "chains", *([None] * (states.ndim - 2)))
    states = _gput(states, NamedSharding(mesh, spec))
    # typed key arrays cannot ride make_array_from_callback on a
    # multi-process mesh; shard the raw key DATA and rebuild the typed
    # keys inside the jitted region (wrap(key_data(k)) == k bitwise)
    kd = _gput(jax.random.key_data(keys),
               NamedSharding(mesh, P("disorder", None)))

    def fn(problem, sched, *rest):
        *extra_state, kdata = rest
        return solver_fn(problem, sched, *extra_state,
                         jax.random.wrap_key_data(kdata))

    run = vmap_disorder(fn, axes, extra_axes=(None,) * len(extra_args))
    return run(stacked, sched, *extra_args, states, kd)
