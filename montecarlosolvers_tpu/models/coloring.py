"""Greedy graph coloring — the enabling transform for parallel sweeps.

The reference's Metropolis kernels update spins one at a time in a shuffled
sequential order (Fisher-Yates at sa.pyx:71-79) because a naive parallel
update of interacting spins is not a valid sampler (the reference's own
`prange` variants, sa.pyx:266 / qmc.pyx:110, race by design). Here we
instead partition the interaction graph into independent sets ("colors"):
spins within one color share no coupling, so a whole color class can be
updated simultaneously with exact Metropolis acceptance. Sweeping the colors
in sequence is a valid, race-free sampler whose stationary distribution is
the same Gibbs measure; equivalence to the reference is validated
statistically on residual-energy distributions (SURVEY.md §4).

Bipartite lattices (e.g. the 80x80 benchmark instance) color with 2 classes
(checkerboard); arbitrary padded-neighbor graphs get greedy coloring with at
most max_degree + 1 classes.
"""

from __future__ import annotations

import numpy as np


def greedy_coloring(nbr_idx, nbr_val=None):
    """Greedy color the interaction graph given a padded neighbor table.

    Args:
      nbr_idx: (N, maxnb) int array of neighbor indices (self-index entries
               are ignored — they encode fields/padding).
      nbr_val: optional (N, maxnb) coupling values; slots with value 0 are
               ignored (padding contributes no interaction).

    Returns:
      (colors, num_colors): (N,) int32 array and the class count.
    """
    nbr_idx = np.asarray(nbr_idx)
    nspins, maxnb = nbr_idx.shape

    try:
        from montecarlosolvers_tpu.native import greedy_color_native

        out = greedy_color_native(nbr_idx, nbr_val)
        if out is not None:
            return out
    except Exception:
        pass

    own = np.arange(nspins)[:, None]
    active = nbr_idx != own
    if nbr_val is not None:
        active &= np.asarray(nbr_val) != 0.0

    colors = np.full(nspins, -1, dtype=np.int32)
    for i in range(nspins):
        used = set()
        for k in range(maxnb):
            if active[i, k]:
                c = colors[nbr_idx[i, k]]
                if c >= 0:
                    used.add(c)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors, int(colors.max()) + 1


def ring_coloring(length):
    """Color a periodic ring (the Trotter imaginary-time axis, qmc.pyx:126-138).

    2 colors when even, 3 when odd (the wrap edge breaks parity).
    """
    colors = np.arange(length, dtype=np.int32) % 2
    if length % 2 == 1 and length > 1:
        colors[-1] = 2
    n = int(colors.max()) + 1 if length > 1 else 1
    return colors, n
