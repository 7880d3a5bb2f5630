"""Disorder (multi-instance) batching: anneal many coupling realizations
of one graph topology in a single launch.

The reference runs disorder realizations as separate processes; here the
realization axis is a vmap axis over the problem's coupling leaves (the
topology — neighbor indices and coloring — is shared, so the compiled
program is identical per instance). Combined with chain batching this is
the SURVEY.md §2.3 independent instance/disorder axis at any scale: vmap
on one device, or shard the disorder axis over a mesh with
parallel/mesh.py and parallel/multihost.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models.ising import IsingProblem


def stack_problems(problems):
    """Stack same-topology IsingProblems along a leading disorder axis.

    Returns (stacked_problem, in_axes_problem) where in_axes_problem is the
    pytree to pass as the problem's vmap in_axes (couplings mapped, topology
    broadcast).
    """
    from montecarlosolvers_tpu.models.coloring import greedy_coloring

    p0 = problems[0]
    idx0 = np.asarray(p0.nbr_idx)
    for p in problems[1:]:
        if p.nspins != p0.nspins or p.maxnb != p0.maxnb:
            raise ValueError("problems must share topology")
        if not np.array_equal(np.asarray(p.nbr_idx), idx0):
            raise ValueError("problems must share the neighbor structure")
    # Recolor topology-only (every non-self slot counts as an edge): a slot
    # that is zero in p0 but nonzero in another realization must still
    # separate its endpoints, or the stacked colored sweep would race.
    colors, num_colors = greedy_coloring(idx0, None)
    color_masks = jnp.asarray(
        colors[None, :] == np.arange(num_colors)[:, None]
    )
    stacked = dataclasses.replace(
        p0,
        nbr_J=jnp.stack([p.nbr_J for p in problems]),
        h=jnp.stack([p.h for p in problems]),
        color_masks=color_masks,
        num_colors=int(num_colors),
    )
    in_axes = dataclasses.replace(
        _axes_like(stacked), nbr_J=0, h=0
    )
    return stacked, in_axes


def _axes_like(p):
    """An IsingProblem-shaped pytree of vmap axes, all None (broadcast)."""
    return IsingProblem(
        nbr_idx=None, nbr_J=None, h=None, color_masks=None,
        nspins=p.nspins, maxnb=p.maxnb, num_colors=p.num_colors,
    )


def vmap_disorder(solver_fn, stacked_axes, state_axis=0, key_axis=0,
                  extra_axes=()):
    """vmap a solver over the disorder axis.

    solver_fn(problem, *args) with args = (sched_or_a..., state, key) —
    schedules broadcast, state and key map. For the common
    `fn(problem, sched, state, key)` signature:

    >>> stacked, axes = stack_problems(list_of_problems)
    >>> run = vmap_disorder(sa.anneal, axes)
    >>> out = run(stacked, sched, states, keys)   # states: (D, ..., N)
    """
    in_axes = (stacked_axes, None) + tuple(extra_axes) + (state_axis, key_axis)
    return jax.vmap(solver_fn, in_axes=in_axes)
