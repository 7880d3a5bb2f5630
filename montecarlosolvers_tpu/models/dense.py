"""Dense (fully-connected) Ising problems — the matmul path.

For dense coupling matrices (Sherrington-Kirkpatrick-class), the padded
neighbor table degenerates (maxnb = N-1) and graph coloring degenerates
with it (a complete graph needs N colors, i.e. a fully sequential sweep).
The right engine is different: local fields are a (chains, N) x (N, B)
matmul, and the sweep runs block-sequentially with rank-1
delayed updates (ops/dense_sweep.py) — the exact sequential Metropolis
semantics of the reference (sa.pyx:81-99, systematic scan order) at
matrix-product throughput.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

# Couplings are arbitrary float32: a TF32 contraction (about three decimal
# digits) would perturb every local field, dE and acceptance decision.
_FULL_F32 = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseProblem:
    """Fully-connected Ising problem.

    J: (N, N) float32, symmetric, zero diagonal — each undirected coupling
       stored in BOTH halves, so H(s) = 1/2 s J s + h s and each pair
       counts once (matching IsingProblem's convention).
    h: (N,) float32 local fields.
    """

    J: jax.Array
    h: jax.Array
    nspins: int = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def from_couplings(cls, J, h=None):
        """Build from a dense matrix, either storage convention:

        * already-symmetric J (both halves stored, pair weight J_ij) is
          used as-is;
        * otherwise (upper-triangular or arbitrary full storage) each
          stored entry counts once: J_sym = J + J^T.

        The diagonal always moves into h.
        """
        J = np.asarray(J, dtype=np.float64)
        n = J.shape[0]
        d = np.diag(J).copy()
        Joff = J.copy()
        np.fill_diagonal(Joff, 0.0)
        if np.allclose(Joff, Joff.T):
            Js = Joff
        else:
            Js = Joff + Joff.T
        hv = d + (np.zeros(n) if h is None else np.asarray(h, np.float64))
        return cls(
            J=jnp.asarray(Js, jnp.float32),
            h=jnp.asarray(hv, jnp.float32),
            nspins=int(n),
        )

    @classmethod
    def from_edges(cls, nspins, rows, cols, vals):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=np.float64)
        J = np.zeros((nspins, nspins))
        h = np.zeros(nspins)
        off = rows != cols
        np.add.at(J, (rows[off], cols[off]), vals[off])
        np.add.at(J, (cols[off], rows[off]), vals[off])
        np.add.at(h, rows[~off], vals[~off])
        return cls(
            J=jnp.asarray(J, jnp.float32),
            h=jnp.asarray(h, jnp.float32),
            nspins=int(nspins),
        )

    # ------------------------------------------------------------ interface
    def local_fields(self, s):
        """sum_j J_ij s_j + h_i via matmul; s: (..., N)."""
        s = s.astype(self.J.dtype)
        return (
            jnp.einsum("...n,nm->...m", s, self.J, precision=_FULL_F32,
                       preferred_element_type=jnp.float32)
            + self.h
        )

    def energy(self, s):
        s = s.astype(self.J.dtype)
        f = jnp.einsum("...n,nm->...m", s, self.J, precision=_FULL_F32,
                       preferred_element_type=jnp.float32)
        return 0.5 * jnp.sum(f * s, axis=-1) + jnp.sum(self.h * s, axis=-1)

    def delta_e(self, s):
        s = s.astype(self.J.dtype)
        return -2.0 * s * self.local_fields(s)
