"""Structured 2D-lattice Ising problems — the lattice fast path.

The benchmark instance (santoro 80x80, examples/ising_instances/) is a
square lattice with right/down bonds; representing it as per-direction
coupling planes turns the neighbor gather of the generic path
(tools.pyx:28-96 format) into four `roll`+FMA ops — no gathers at all,
only contiguous shifted reads. Open boundaries
are encoded by zero couplings on the wrap edges, so periodic lattices come
for free (nonzero wrap couplings).

`LatticeProblem` exposes the same interface as `IsingProblem`
(local_fields / energy / delta_e on flat (..., N) states, plus
color_masks/num_colors = the checkerboard), so every sweep op, solver, and
the Trotter sharding layer work on it unchanged — the lattice structure
only changes *how* fields are computed. Spin index i = r*L + c, matching
the triplet files (examples/santoro80.py:242-244).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models.ising import IsingProblem


def checkerboard_masks(L):
    """(2, L*L) bool checkerboard — the lattice specialization of the greedy
    coloring (bipartite; sa.pyx's sequential order becomes 2 phases)."""
    r = np.arange(L)[:, None]
    c = np.arange(L)[None, :]
    par = ((r + c) % 2).reshape(-1)
    return np.stack([par == 0, par == 1])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LatticeProblem:
    """2D lattice Ising problem with per-direction coupling planes.

    j_right[r, c]: coupling between (r, c) and (r, c+1 mod L); the wrap
      column is zero for open boundaries.
    j_down[r, c]:  coupling between (r, c) and (r+1 mod L, c).
    h_plane[r, c]: local field.
    color_masks:   (2, L*L) checkerboard (flat), same contract as
                   IsingProblem.color_masks.
    """

    j_right: jax.Array
    j_down: jax.Array
    h_plane: jax.Array
    color_masks: jax.Array
    L: int = dataclasses.field(metadata=dict(static=True))
    # True iff any horizontal wrap coupling (j_right[:, -1]) is nonzero.
    # The split-checkerboard engine (ops/split.py) needs two extra
    # roll-correction slots exactly when this is set; vertical wrap and
    # open boundaries are exact in its base 5-slot stencil.
    col_wrap: bool = dataclasses.field(
        default=True, metadata=dict(static=True)
    )

    num_colors = 2

    @classmethod
    def from_planes(cls, j_right, j_down, h=None, col_wrap=None):
        """col_wrap: pass explicitly when the planes are JAX tracers (it
        must be static); with concrete planes it is detected. The default
        under tracing is True — always correct, two extra stencil slots."""
        if col_wrap is None:
            if isinstance(j_right, jax.core.Tracer):
                col_wrap = True
            else:
                col_wrap = bool(np.any(np.asarray(j_right)[:, -1] != 0.0))
        j_right = jnp.asarray(j_right, dtype=jnp.float32)
        L = j_right.shape[0]
        if h is None:
            h = jnp.zeros((L, L), dtype=jnp.float32)
        return cls(
            j_right=j_right,
            j_down=jnp.asarray(j_down, dtype=jnp.float32),
            h_plane=jnp.asarray(h, dtype=jnp.float32),
            color_masks=jnp.asarray(checkerboard_masks(L)),
            L=int(L),
            col_wrap=col_wrap,
        )

    @classmethod
    def from_edges(cls, L, rows, cols, vals):
        """Build from COO triplets over row-major spin indices. Raises if an
        edge is not a lattice right/down/wrap/field bond."""
        jr = np.zeros((L, L))
        jd = np.zeros((L, L))
        h = np.zeros((L, L))
        for a, b, v in zip(np.asarray(rows), np.asarray(cols), np.asarray(vals)):
            a, b = int(a), int(b)
            lo, hi = min(a, b), max(a, b)
            r, c = divmod(lo, L)
            if a == b:
                h[r, c] += v
            elif hi - lo == 1 and c + 1 < L:
                jr[r, c] += v
            elif hi - lo == L:
                jd[r, c] += v
            elif hi - lo == L - 1 and divmod(hi, L)[0] == r:
                jr[r, L - 1] += v  # periodic wrap in the row
            elif hi - lo == L * (L - 1):
                jd[L - 1, c] += v  # periodic wrap in the column
            else:
                raise ValueError(f"edge ({a},{b}) is not a 2D-lattice bond")
        return cls.from_planes(jr, jd, h)

    # ------------------------------------------------------------ interface
    @property
    def nspins(self):
        return self.L * self.L

    @property
    def h(self):
        """Flat local fields (IsingProblem interface parity)."""
        return self.h_plane.reshape(-1)

    @property
    def j_left(self):
        return jnp.roll(self.j_right, 1, axis=-1)

    @property
    def j_up(self):
        return jnp.roll(self.j_down, 1, axis=-2)

    def _planes(self, s):
        return s.reshape(s.shape[:-1] + (self.L, self.L))

    def local_fields(self, s):
        """sum_nb J s_nb + h for flat spins s: (..., L*L)."""
        sp = self._planes(s.astype(self.j_right.dtype))
        f = self.j_right * jnp.roll(sp, -1, axis=-1)
        f = f + self.j_left * jnp.roll(sp, 1, axis=-1)
        f = f + self.j_down * jnp.roll(sp, -1, axis=-2)
        f = f + self.j_up * jnp.roll(sp, 1, axis=-2)
        f = f + self.h_plane
        return f.reshape(s.shape)

    def energy(self, s):
        """H(s) = sum_bonds J s s + sum h s over flat (..., L*L) states."""
        sp = self._planes(s.astype(self.j_right.dtype))
        e = jnp.sum(self.j_right * sp * jnp.roll(sp, -1, axis=-1), axis=(-1, -2))
        e = e + jnp.sum(self.j_down * sp * jnp.roll(sp, -1, axis=-2), axis=(-1, -2))
        return e + jnp.sum(self.h_plane * sp, axis=(-1, -2))

    def delta_e(self, s):
        s = s.astype(self.j_right.dtype)
        return -2.0 * s * self.local_fields(s)

    def to_generic(self, maxnb=None):
        """Convert to the padded-gather IsingProblem (oracle checks, cluster
        updates, and any op that needs the explicit neighbor table)."""
        L = self.L
        jr = np.asarray(self.j_right)
        jd = np.asarray(self.j_down)
        h = np.asarray(self.h_plane)
        rows, cols, vals = [], [], []
        for r in range(L):
            for c in range(L):
                i = r * L + c
                if jr[r, c] != 0.0:
                    rows.append(i)
                    cols.append(r * L + (c + 1) % L)
                    vals.append(jr[r, c])
                if jd[r, c] != 0.0:
                    rows.append(i)
                    cols.append(((r + 1) % L) * L + c)
                    vals.append(jd[r, c])
                if h[r, c] != 0.0:
                    rows.append(i)
                    cols.append(i)
                    vals.append(h[r, c])
        return IsingProblem.from_edges(
            L * L, np.array(rows), np.array(cols), np.array(vals),
            maxnb=maxnb if maxnb is not None else 5,
        )
