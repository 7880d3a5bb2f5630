"""Device-mesh helpers: the replacement for the reference's process
model (SURVEY.md §2.3 — the reference has shared-memory OpenMP only; here
devices form a `jax.sharding.Mesh` and XLA lowers the collectives).

The mesh is a flat list of devices shaped by the algorithm alone: on one
host the cards are peers joined all to all, so no axis order is favoured
by the interconnect.

Axes convention:
  "chains"  — independent annealing trajectories (data parallel; the analog
              of the reference's read-parallel OpenMP loop, svmc.pyx:624).
  "replica" — Trotter imaginary-time slices (model parallel; each device
              owns a block of the ring — see parallel/trotter.py).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(chains=None, replica=None, devices=None):
    """Build a 1- or 2-axis mesh. Sizes default to using all devices on the
    chains axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if chains is None and replica is None:
        chains = devices.size
    if replica is None:
        return Mesh(devices[:chains], axis_names=("chains",))
    if chains is None:
        return Mesh(devices[:replica], axis_names=("replica",))
    return Mesh(
        devices[: chains * replica].reshape(chains, replica),
        axis_names=("chains", "replica"),
    )


def chain_sharding(mesh, ndim):
    """NamedSharding placing the leading (chain) axis on the "chains" mesh
    axis, everything else replicated."""
    spec = P("chains", *([None] * (ndim - 1)))
    return NamedSharding(mesh, spec)


def shard_chains(state, mesh):
    """Shard a (chains, ...) state across the "chains" mesh axis.

    Solvers are pure elementwise-in-chain programs, so under this sharding
    XLA runs them SPMD with zero communication — results are bitwise equal
    to the unsharded run (tested in tests/test_parallel.py).
    """
    return jax.device_put(state, chain_sharding(mesh, state.ndim))
