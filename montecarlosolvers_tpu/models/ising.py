"""Ising problem representation: the sparse->padded "problem compiler".

Re-designs the reference's neighbor-table format (tools.pyx:28-96,
`GenerateNeighbors`) for vector hardware: the padded fixed-degree table maps to a
vectorized gather, the diagonal local-field convention (entries with
neighbor-index == own-index, consumed at sa.pyx:89-91) is split out at
compile time into a dense field vector `h` so the hot path is a pure
masked gather + FMA with no per-element branching.

Energy convention (matches tools.pyx:99-118 and sa.pyx:84-94):

    H(s) = sum_{stored pairs (i,j)} J_ij s_i s_j + sum_i h_i s_i
    dE_i(flip) = -2 s_i * ( sum_{j in nb(i)} J_ij s_j + h_i )

Each stored off-diagonal coupling appears once in H; the neighbor table
lists it in both endpoints' rows so dE is local.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models.coloring import greedy_coloring


def bits2spins(vec):
    """Bit (0/1) -> spin (+1/-1) convention of tools.pyx:20-22 (1 maps to -1)."""
    vec = jnp.asarray(vec)
    return jnp.where(vec == 1, -1, 1)


def spins2bits(vec):
    """Spin (+1/-1) -> bit (0/1) convention of tools.pyx:24-26 (+1 maps to 0)."""
    vec = jnp.asarray(vec)
    return jnp.where(vec == 1, 0, 1)


def _coo_from_any(J, nspins):
    """Extract COO triplets (rows, cols, vals) from scipy sparse / dense / dict."""
    if hasattr(J, "tocoo"):  # scipy sparse
        coo = J.tocoo()
        return (
            np.asarray(coo.row, dtype=np.int64),
            np.asarray(coo.col, dtype=np.int64),
            np.asarray(coo.data, dtype=np.float64),
        )
    if isinstance(J, dict):
        keys = np.array(list(J.keys()), dtype=np.int64).reshape(-1, 2)
        vals = np.array(list(J.values()), dtype=np.float64)
        return keys[:, 0], keys[:, 1], vals
    J = np.asarray(J)
    if J.ndim == 2 and J.shape == (nspins, nspins):
        rows, cols = np.nonzero(J)
        return rows.astype(np.int64), cols.astype(np.int64), J[rows, cols].astype(np.float64)
    raise TypeError(f"Unsupported coupling container: {type(J)}")


def build_neighbor_table(nspins, rows, cols, vals, maxnb):
    """O(nnz) sparse->dense compile of the (nspins, maxnb, 2) neighbor table.

    Semantics identical to tools.pyx:28-96 (each stored pair (a, b) adds b to
    a's row and a to b's row; diagonal entries land in their own row and
    encode local fields), but linear-time instead of the reference's
    O(N * nnz) DOK scan. Uses the native C++ compiler when available.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)

    try:
        from montecarlosolvers_tpu.native import neighbor_table_native

        out = neighbor_table_native(nspins, rows, cols, vals, maxnb)
        if out is not None:
            return out
    except Exception:
        pass

    nbs = np.zeros((nspins, maxnb, 2), dtype=np.float64)
    fill = np.zeros(nspins, dtype=np.int64)

    def _push(i, j, v):
        k = fill[i]
        if k >= maxnb:
            raise ValueError(
                f"spin {i} has more than maxnb={maxnb} neighbors; raise maxnb"
            )
        nbs[i, k, 0] = j
        nbs[i, k, 1] = v
        fill[i] = k + 1

    for a, b, v in zip(rows, cols, vals):
        if a == b:
            _push(a, a, v)
        else:
            _push(a, b, v)
            _push(b, a, v)
    return nbs


def generate_neighbors(nspins, J, maxnb, savepath=None):
    """Drop-in analog of tools.GenerateNeighbors (tools.pyx:28-96).

    Args:
      nspins: number of spins.
      J: scipy.sparse matrix / dict {(i, j): val} / dense (N, N) array.
         Diagonal entries encode local fields h_i.
      maxnb: max neighbors per spin (fields count as one neighbor).
      savepath: optional .npy cache path (tools.pyx:94-95).

    Returns:
      (nspins, maxnb, 2) float64 array: [:, :, 0] neighbor index,
      [:, :, 1] coupling value; zero-padded rows contribute zero energy.
    """
    rows, cols, vals = _coo_from_any(J, nspins)
    nbs = build_neighbor_table(nspins, rows, cols, vals, maxnb)
    if savepath is not None:
        np.save(savepath, nbs)
    return nbs


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IsingProblem:
    """Compiled Ising problem, ready for device sweeps.

    Data fields (pytree leaves):
      nbr_idx:     (N, maxnb) int32, neighbor index per slot (self for pads).
      nbr_J:       (N, maxnb) float32, quadratic coupling per slot; zero for
                   padding and for local-field slots (those are folded into h).
      h:           (N,) float32, local fields (diagonal of J).
      color_masks: (num_colors, N) bool, partition of spins into independent
                   (non-interacting) sets — the parallel replacement for the
                   reference's sequential shuffled sweep order (sa.pyx:71-79).

    Static fields:
      nspins, maxnb, num_colors.
    """

    nbr_idx: jax.Array
    nbr_J: jax.Array
    h: jax.Array
    color_masks: jax.Array
    nspins: int = dataclasses.field(metadata=dict(static=True))
    maxnb: int = dataclasses.field(metadata=dict(static=True))
    num_colors: int = dataclasses.field(metadata=dict(static=True))

    # ---------------------------------------------------------- constructors
    @classmethod
    def from_neighbor_table(cls, nbs):
        """Build from a reference-format (N, maxnb, 2) neighbor table."""
        nbs = np.asarray(nbs)
        nspins, maxnb, _ = nbs.shape
        idx = nbs[:, :, 0].astype(np.int64)
        val = nbs[:, :, 1].astype(np.float64)
        own = np.arange(nspins)[:, None]
        is_self = idx == own
        # Padding slots are (0, 0.0): their value contribution is zero either
        # way, but route them to "self" so gathers stay in-row.
        is_pad = (val == 0.0) & (idx == 0) & (own != 0)
        h = np.where(is_self, val, 0.0).sum(axis=1)
        quad_val = np.where(is_self | is_pad, 0.0, val)
        quad_idx = np.where(is_self | is_pad, own, idx)
        colors, num_colors = greedy_coloring(quad_idx, quad_val)
        color_masks = colors[None, :] == np.arange(num_colors)[:, None]
        return cls(
            nbr_idx=jnp.asarray(quad_idx, dtype=jnp.int32),
            nbr_J=jnp.asarray(quad_val, dtype=jnp.float32),
            h=jnp.asarray(h, dtype=jnp.float32),
            color_masks=jnp.asarray(color_masks),
            nspins=int(nspins),
            maxnb=int(maxnb),
            num_colors=int(num_colors),
        )

    @classmethod
    def from_couplings(cls, nspins, J, maxnb):
        """Build straight from a sparse/dense coupling container."""
        return cls.from_neighbor_table(generate_neighbors(nspins, J, maxnb))

    @classmethod
    def from_qubo(cls, Q, maxnb=None):
        """Build from a QUBO: minimize x^T Q x over x in {0,1}^n.

        Uses the bit<->spin convention of tools.pyx:20-26 (bit 1 <-> spin
        -1), i.e. x = (1 - s) / 2. The constant offset is returned so QUBO
        objectives can be recovered: x Q x = H(s) + offset.

        Returns (problem, offset).
        """
        Q = np.asarray(Q, dtype=np.float64)
        n = Q.shape[0]
        Q = (Q + Q.T) / 2.0  # symmetrize; off-diagonal pairs merge below
        rows_l, cols_l, vals_l = [], [], []
        h = np.zeros(n)
        offset = 0.0
        for i in range(n):
            qii = Q[i, i]
            # x_i = (1 - s_i)/2 -> qii x_i = qii/2 - (qii/2) s_i
            h[i] += -qii / 2.0
            offset += qii / 2.0
            for j in range(i + 1, n):
                qij = 2.0 * Q[i, j]  # symmetrized pair weight
                if qij == 0.0:
                    continue
                # qij x_i x_j = qij/4 (1 - s_i - s_j + s_i s_j)
                rows_l.append(i)
                cols_l.append(j)
                vals_l.append(qij / 4.0)
                h[i] += -qij / 4.0
                h[j] += -qij / 4.0
                offset += qij / 4.0
        for i in range(n):
            if h[i] != 0.0:
                rows_l.append(i)
                cols_l.append(i)
                vals_l.append(h[i])
        problem = cls.from_edges(
            n, np.array(rows_l, dtype=np.int64),
            np.array(cols_l, dtype=np.int64), np.array(vals_l), maxnb=maxnb
        )
        return problem, float(offset)

    @classmethod
    def from_edges(cls, nspins, rows, cols, vals, maxnb=None):
        """Build from COO triplets (diagonal entries = local fields)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if maxnb is None:
            deg = np.zeros(nspins, dtype=np.int64)
            off = rows != cols
            np.add.at(deg, rows[off], 1)
            np.add.at(deg, cols[off], 1)
            np.add.at(deg, rows[~off], 1)
            maxnb = int(deg.max()) if deg.size else 1
        return cls.from_neighbor_table(
            build_neighbor_table(nspins, rows, cols, vals, maxnb)
        )

    # ------------------------------------------------------------- energetics
    def local_fields(self, spins):
        """sum_j J_ij s_j + h_i for every spin; spins: (..., N) float or int."""
        s = spins.astype(self.nbr_J.dtype)
        sj = jnp.take(s, self.nbr_idx, axis=-1)  # (..., N, maxnb)
        return jnp.sum(self.nbr_J * sj, axis=-1) + self.h

    def energy(self, spins):
        """H(s); batched over leading dims of spins."""
        s = spins.astype(self.nbr_J.dtype)
        sj = jnp.take(s, self.nbr_idx, axis=-1)
        quad = jnp.sum(self.nbr_J * sj, axis=-1)  # counts each edge twice
        return 0.5 * jnp.sum(quad * s, axis=-1) + jnp.sum(self.h * s, axis=-1)

    def delta_e(self, spins):
        """dE of flipping each spin: -2 s_i (sum_j J_ij s_j + h_i) (sa.pyx:91-94)."""
        s = spins.astype(self.nbr_J.dtype)
        return -2.0 * s * self.local_fields(s)


def classical_ising_energy(spins, J):
    """Analog of tools.ClassicalIsingEnergy (tools.pyx:99-118).

    @J may be scipy sparse or dense; off-diagonal stored entries count once,
    diagonal entries are local fields.
    """
    if hasattr(J, "todense"):
        J = np.asarray(J.todense())
    J = np.asarray(J, dtype=np.float64)
    s = np.asarray(spins, dtype=np.float64)
    d = np.diag(J).copy()
    Joff = J.copy()
    np.fill_diagonal(Joff, 0.0)
    return float(s @ (Joff @ s) + np.sum(d * s))
