"""Split-checkerboard state layout — the bandwidth-optimal sweep engine.

The colored sweeps in ops/metropolis.py and ops/piqmc.py compute fields for
the *whole* lattice every phase and mask out the inactive color — half the
elementwise work and all of the uniform draws are wasted, and the (L, L)
plane layout pads L=80 lanes up to 128 (37.5% dead lanes at benchmark
shape). This module stores the state as the two checkerboard half-lattices
instead, flattened to Nh = L*L/2 (= 3200 = 25*128 for the benchmark: zero
lane padding). Each Metropolis phase then updates one *entire* half-array
with no masks, reading only the opposite half.

Spatial fields in the split layout: site j of color c has its four lattice
neighbors at flat offsets {0, +1, -1, +K, -K} (K = L/2) of the *opposite*
half-array, with per-offset coupling weights precomputed from the
j_right/j_down planes. The +/-K rolls are exact even across the array
wrap: for even L the checkerboard colors of rows L-1 and 0 swap parity, so
the flat wrap lands on the correct vertical-wrap neighbor — periodic
columns come for free. The +/-1 rolls graze row boundaries at one site per
row (col 0 / col L-1); for open rows the weights there are the zero wrap
couplings, and for periodic rows (LatticeProblem.col_wrap) two extra
correction slots at offsets +/-(K-1) carry the row-wrap bonds (the wrap
neighbor of (r, L-1) lives at flat r*K, i.e. K-1 positions back).

For PIQMC the two phase sets of the space-time coloring
(ops/piqmc.py: phase(i, k) = (color(i) + k) mod 2, bipartite + even P)
are materialized as arrays X, Y of shape (..., P/2, 2, Nh):

    X[..., q, t, :] = slice k = 2q + t, color A if k even else color B
    Y[..., q, t, :] = slice k = 2q + t, color B if k even else color A

X sites are mutually non-interacting (spatial neighbors differ in color at
equal k; Trotter neighbors differ in k parity), so one phase updates all of
X given Y exactly — the maskless form of ops/piqmc.local_sweep. Global
line moves (qmc.pyx:405-438) read half-volume fields per color.

Replaces (as a fast path; the generic ops remain for arbitrary graphs):
  sweep_scan / colored_metropolis_sweep  (sa.pyx:19-101 hot loop)
  piqmc.local_sweep + global_line_moves  (qmc.pyx:97-143, 405-438)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.ops.metropolis import metropolis_accept
from montecarlosolvers_tpu.ops.piqmc import BATH_PRECISION
from montecarlosolvers_tpu.ops.svmc_ops import z_projection_from_cos
from montecarlosolvers_tpu.schedules import jperp as jperp_of


def supports_split(problem, slices=None):
    """True when `problem` (and, for PIQMC, the slice count) can use the
    split-checkerboard engine."""
    from montecarlosolvers_tpu.models.lattice import LatticeProblem

    ok = isinstance(problem, LatticeProblem) and problem.L % 2 == 0
    if slices is not None:
        ok = ok and slices % 2 == 0
    return ok


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SplitLattice:
    """Precomputed split-layout weights for one LatticeProblem.

    w_ab: (5 or 7, 2, Nh) spatial coupling weights; first axis is the flat
      offset slot (0, +1, -1, +K, -K[, +(K-1), -(K-1)]), second is the site
      color (0 = A = checkerboard parity 0, 1 = B). Slot `+1` weight at j
      multiplies the opposite half's value at j+1, etc. The two extra
      row-wrap slots exist only when col_wrap.
    h_ab: (2, Nh) local fields per color.
    idx_a / idx_b: (Nh,) flat lattice indices of each color's sites
      (row-major within rows, ascending column), as numpy constants.
    """

    w_ab: jax.Array
    h_ab: jax.Array
    L: int = dataclasses.field(metadata=dict(static=True))
    col_wrap: bool = dataclasses.field(metadata=dict(static=True))
    idx_a: tuple = dataclasses.field(metadata=dict(static=True))
    idx_b: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def K(self):
        return self.L // 2

    @property
    def nh(self):
        return self.L * self.L // 2


def _color_indices(L):
    """(idx, cols) for both colors: idx[c] is the (L, K) flat lattice index
    plane of color c sites, cols[c] the matching column plane."""
    K = L // 2
    rows = np.arange(L)[:, None]
    ks = np.arange(K)[None, :]
    out_idx, out_cols = [], []
    for color in (0, 1):
        cols = 2 * ks + (rows + color) % 2  # (L, K)
        out_idx.append(rows * L + cols)
        out_cols.append(cols)
    return out_idx, out_cols


def build_split(problem):
    """Build the SplitLattice weights from a LatticeProblem. Traceable: the
    coupling planes may be tracers (only the index pattern is static)."""
    L = problem.L
    if L % 2:
        raise ValueError("split layout requires even L")
    idxs, colss = _color_indices(L)
    rows = np.arange(L)[:, None]

    ws, hs = [], []
    for color in (0, 1):
        cols = colss[color]
        even = cols % 2 == 0
        jr_right = problem.j_right[rows, cols]  # bond to (r, col+1)
        jr_left = problem.j_right[rows, (cols - 1) % L]  # bond to (r, col-1)
        # even col: right neighbor shares the flat index (offset 0), left
        # neighbor is at -1; odd col: right at +1, left at offset 0. The
        # +/-K vertical slots are wrap-exact (module docstring).
        w0 = jnp.where(even, jr_right, jr_left)
        wp = jnp.where(even, 0.0, jr_right)
        wm = jnp.where(even, jr_left, 0.0)
        wd = problem.j_down[rows, cols]
        wu = problem.j_down[(rows - 1) % L, cols]
        slots = [w0, wp, wm, wd, wu]
        if problem.col_wrap:
            # the flat +/-1 rolls graze the row boundary at col L-1 / 0;
            # move those row-wrap bonds to the +/-(K-1) correction slots
            graze_p = cols == L - 1
            graze_m = cols == 0
            slots = [
                w0,
                jnp.where(graze_p, 0.0, wp),
                jnp.where(graze_m, 0.0, wm),
                wd,
                wu,
                jnp.where(graze_p, wp, 0.0),
                jnp.where(graze_m, wm, 0.0),
            ]
        ws.append(jnp.stack([w.reshape(-1) for w in slots]))
        hs.append(problem.h_plane[rows, cols].reshape(-1))

    return SplitLattice(
        w_ab=jnp.stack(ws, axis=1).astype(jnp.float32),  # (5|7, 2, Nh)
        h_ab=jnp.stack(hs).astype(jnp.float32),  # (2, Nh)
        L=L,
        col_wrap=problem.col_wrap,
        idx_a=tuple(idxs[0].reshape(-1).tolist()),
        idx_b=tuple(idxs[1].reshape(-1).tolist()),
    )


def _spatial_field(w, o, K):
    """Weighted neighbor sum over the opposite half `o` (..., Nh). `w` is
    (5|7, ..., Nh) (color axis broadcastable against o); slots 5-6 are the
    row-wrap corrections, present only for col_wrap lattices."""
    f = (
        w[0] * o
        + w[1] * jnp.roll(o, -1, axis=-1)
        + w[2] * jnp.roll(o, 1, axis=-1)
        + w[3] * jnp.roll(o, -K, axis=-1)
        + w[4] * jnp.roll(o, K, axis=-1)
    )
    if w.shape[0] > 5:
        f = f + w[5] * jnp.roll(o, K - 1, axis=-1)
        f = f + w[6] * jnp.roll(o, -(K - 1), axis=-1)
    return f


# --------------------------------------------------------------- classical SA


def pack_classical(sl, spins):
    """(..., N) -> (a, b) halves (..., Nh)."""
    idx_a = jnp.asarray(sl.idx_a)
    idx_b = jnp.asarray(sl.idx_b)
    return jnp.take(spins, idx_a, axis=-1), jnp.take(spins, idx_b, axis=-1)


def _inverse_perm(sl):
    perm = np.concatenate([np.asarray(sl.idx_a), np.asarray(sl.idx_b)])
    return jnp.asarray(np.argsort(perm))


def unpack_classical(sl, a, b):
    return jnp.take(jnp.concatenate([a, b], axis=-1), _inverse_perm(sl), axis=-1)


def classical_energy_split(sl, a, b):
    """H = sum_bonds J s s + sum h s on split halves. Every lattice bond
    joins opposite colors, so sum_A s_A * spatial_field_A counts each bond
    exactly once."""
    f = _spatial_field(sl.w_ab[:, 0], b, sl.K)
    return (
        jnp.sum(a * f, axis=-1)
        + jnp.sum(sl.h_ab[0] * a, axis=-1)
        + jnp.sum(sl.h_ab[1] * b, axis=-1)
    )


def sa_split_sweep(sl, a, b, key, temp):
    """One full SA sweep (two maskless half-phases). Matches the Gibbs
    measure of colored_metropolis_sweep on the same lattice."""
    ka, kb = jax.random.split(key)
    f = _spatial_field(sl.w_ab[:, 0], b, sl.K) + sl.h_ab[0]
    de = -2.0 * a * f
    a = jnp.where(metropolis_accept(de, temp, jax.random.uniform(ka, a.shape)), -a, a)
    f = _spatial_field(sl.w_ab[:, 1], a, sl.K) + sl.h_ab[1]
    de = -2.0 * b * f
    b = jnp.where(metropolis_accept(de, temp, jax.random.uniform(kb, b.shape)), -b, b)
    return a, b


def sa_anneal_split(problem, temps, spins, key, collect_energy=False,
                    state_dtype=jnp.bfloat16):
    """Split-layout SA anneal scan — drop-in inner engine for
    solvers.sa.anneal on open-boundary even-L lattices.

    state_dtype: storage dtype of the (a, b) scan carry. Spins are
    exactly +/-1 in bfloat16 and every contraction promotes to float32
    before meeting the float32 couplings, so trajectories are BITWISE
    identical to float32 storage (SA dE is purely elementwise; see
    qmc_anneal_split) at half the carry bandwidth. Collected energies
    may differ in the last ULP — XLA fuses the promoted product into
    the reduction differently per storage dtype, reordering the sum.
    Pass jnp.float32 to opt out."""
    sl = build_split(problem)
    in_dtype = spins.dtype
    a, b = (q.astype(state_dtype) for q in pack_classical(sl, spins))
    temps = jnp.asarray(temps)
    keys = jax.random.split(key, temps.shape[0])

    def body(carry, x):
        a, b = carry
        t, k = x
        a, b = sa_split_sweep(sl, a, b, k, t)
        e = classical_energy_split(sl, a, b) if collect_energy else None
        return (a, b), e

    (a, b), es = jax.lax.scan(body, (a, b), (temps, keys))
    return unpack_classical(sl, a.astype(in_dtype), b.astype(in_dtype)), es


# ---------------------------------------------------------------------- SVMC


def _svmc_split_phase(sl, th, cth, sth, cos_other, w, h, kp, kc, temp,
                      a_coeff, b_coeff, tf):
    """One half-phase of the rotor sweep on (theta, cos theta, sin theta).

    Carrying the trig projections of the state (updated on accept via
    select) cuts the transcendental count from 5 sin/cos per site per
    phase (cos other, cos/sin theta, cos/sin prop) to 2 (cos/sin prop) —
    the rotor sweep is transcendental-bound on the VPU, not roll-bound
    like the Ising sweeps. Values are bitwise what the uncached form
    computes (the caches hold exactly cos/sin of the carried angle)."""
    from montecarlosolvers_tpu.ops import svmc_ops

    u_p = jax.random.uniform(kp, th.shape)
    u_c = jax.random.uniform(kc, th.shape)
    prop = (
        svmc_ops.propose_tf(th, u_p, a_coeff, b_coeff)
        if tf else svmc_ops.propose_uniform(u_p)
    )
    cp = jnp.cos(prop)
    sp = jnp.sin(prop)
    zf = _spatial_field(w, cos_other, sl.K) + h
    de = b_coeff * (cp - cth) * zf + a_coeff * (sth - sp)
    acc = metropolis_accept(de, temp, u_c)
    return (
        jnp.where(acc, prop, th),
        jnp.where(acc, cp, cth),
        jnp.where(acc, sp, sth),
    )


def svmc_split_sweep_cached(sl, state, key, temp, a_coeff, b_coeff, tf=False):
    """One maskless SVMC sweep on split angle halves with carried trig
    caches. state = (a, cos a, sin a, b, cos b, sin b). The split form of
    ops/svmc_ops.svmc_sweep; dE per svmc.pyx:96-110."""
    a, ca, sa_, b, cb, sb_ = state
    kpa, kaa, kpb, kab = jax.random.split(key, 4)
    a, ca, sa_ = _svmc_split_phase(
        sl, a, ca, sa_, cb, sl.w_ab[:, 0], sl.h_ab[0], kpa, kaa, temp,
        a_coeff, b_coeff, tf,
    )
    b, cb, sb_ = _svmc_split_phase(
        sl, b, cb, sb_, ca, sl.w_ab[:, 1], sl.h_ab[1], kpb, kab, temp,
        a_coeff, b_coeff, tf,
    )
    return a, ca, sa_, b, cb, sb_


def svmc_split_sweep(sl, a, b, key, temp, a_coeff, b_coeff, tf=False):
    """Single-sweep convenience form of svmc_split_sweep_cached (builds
    and drops the trig caches; use the cached form inside scans)."""
    a, _, _, b, _, _ = svmc_split_sweep_cached(
        sl, (a, jnp.cos(a), jnp.sin(a), b, jnp.cos(b), jnp.sin(b)),
        key, temp, a_coeff, b_coeff, tf=tf,
    )
    return a, b


def svmc_anneal_split(problem, a_sched, b_sched, temp, theta, key, tf=False,
                      collect_energy=False):
    """Split-layout SVMC anneal scan — fast inner engine for
    solvers.svmc.anneal on even-L lattices."""
    sl = build_split(problem)
    a, b = pack_classical(sl, theta)
    keys = jax.random.split(key, a_sched.shape[0])

    def body(carry, x):
        ac, bc, k = x
        carry = svmc_split_sweep_cached(sl, carry, k, temp, ac, bc, tf=tf)
        e = (
            classical_energy_split(
                sl,
                z_projection_from_cos(carry[1]),
                z_projection_from_cos(carry[4]),
            )
            if collect_energy else None
        )
        return carry, e

    state0 = (a, jnp.cos(a), jnp.sin(a), b, jnp.cos(b), jnp.sin(b))
    (a, _, _, b, _, _), es = jax.lax.scan(
        body, state0, (a_sched, b_sched, keys)
    )
    return unpack_classical(sl, a, b), es


# --------------------------------------------------------------------- PIQMC
#
# State = four quarter-volume arrays, each (..., P/2, Nh), indexed by the
# half-Trotter coordinate q (physical slice k = 2q + t):
#
#   xe[q] = slice 2q,   color A        ye[q] = slice 2q,   color B
#   xo[q] = slice 2q+1, color B        yo[q] = slice 2q+1, color A
#
# (xe, xo) is one phase set of the space-time coloring, (ye, yo) the other.
# Keeping the four sub-arrays separate (instead of a stacked (P/2, 2, Nh)
# axis) removes every per-step stack/reshape copy and halves the Trotter
# roll work: each sub-update needs exactly one rolled neighbor array —
#   trotter(xe[q]) = A at slices 2q+-1 = yo[q] + yo[q-1]   (one +1 q-roll)
#   trotter(xo[q]) = B at slices 2q, 2q+2 = ye[q] + ye[q+1] (one -1 q-roll)
# and symmetrically for the Y phase; the q-roll wraps the Trotter ring.


def pack_qmc(sl, confs):
    """(..., P, N) -> (xe, xo, ye, yo), each (..., P/2, Nh)."""
    slices = confs.shape[-2]
    if slices % 2:
        raise ValueError("split PIQMC layout requires even P")
    a = jnp.take(confs, jnp.asarray(sl.idx_a), axis=-1)  # (..., P, Nh)
    b = jnp.take(confs, jnp.asarray(sl.idx_b), axis=-1)
    return (
        a[..., 0::2, :],  # xe: A at even slices
        b[..., 1::2, :],  # xo: B at odd slices
        b[..., 0::2, :],  # ye
        a[..., 1::2, :],  # yo
    )


def unpack_qmc(sl, xe, xo, ye, yo):
    half = xe.shape[-2]
    na = jnp.stack([xe, yo], axis=-2).reshape(xe.shape[:-2] + (2 * half, sl.nh))
    nb = jnp.stack([ye, xo], axis=-2).reshape(na.shape)
    return jnp.take(jnp.concatenate([na, nb], axis=-1), _inverse_perm(sl), axis=-1)


def qmc_split_sweep(sl, xe, xo, ye, yo, key, temp, gamma, b):
    """One full space-time-colored local sweep: phase X = (xe, xo) then
    phase Y = (ye, yo), each a maskless whole-array update (the split form
    of piqmc.local_sweep, qmc.pyx:97-143)."""
    slices = 2 * xe.shape[-2]
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    if jnp.ndim(jp) > 0:
        # per-batch gamma (e.g. a transverse-field PT ladder): broadcast
        # over the (P/2, Nh) trailing axes
        jp = jp[..., None, None]
    bc = -2.0 * b
    wa, ha = sl.w_ab[:, 0], sl.h_ab[0]
    wb, hb = sl.w_ab[:, 1], sl.h_ab[1]
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def upd(s, f_sp_h, tr, k):
        de = bc * s * f_sp_h + 2.0 * s * jp * tr
        u = jax.random.uniform(k, s.shape)
        return jnp.where(metropolis_accept(de, teff, u), -s, s)

    # phase X: xe against (ye spatial, yo ring), xo against (yo, ye)
    xe = upd(xe, _spatial_field(wa, ye, sl.K) + ha,
             yo + jnp.roll(yo, 1, axis=-2), k1)
    xo = upd(xo, _spatial_field(wb, yo, sl.K) + hb,
             ye + jnp.roll(ye, -1, axis=-2), k2)
    # phase Y against the updated X
    ye = upd(ye, _spatial_field(wb, xe, sl.K) + hb,
             xo + jnp.roll(xo, 1, axis=-2), k3)
    yo = upd(yo, _spatial_field(wa, xo, sl.K) + ha,
             xe + jnp.roll(xe, -1, axis=-2), k4)
    return xe, xo, ye, yo


def qmc_split_global(sl, xe, xo, ye, yo, key, temp, b):
    """Whole-line flips (qmc.pyx:405-438) in the split layout. A physical
    line of color A lives in xe (even slices) and yo (odd slices); its dE
    needs only the spatial fields of those quarters — J_perp cancels for a
    full-line flip."""
    slices = 2 * xe.shape[-2]
    teff = temp * slices
    bc = -2.0 * b
    ka, kb = jax.random.split(key)
    wa, ha = sl.w_ab[:, 0], sl.h_ab[0]
    wb, hb = sl.w_ab[:, 1], sl.h_ab[1]

    # color A lines: sites xe + yo, spatial neighbors ye / xo
    de = bc * (
        jnp.sum(xe * (_spatial_field(wa, ye, sl.K) + ha), axis=-2)
        + jnp.sum(yo * (_spatial_field(wa, xo, sl.K) + ha), axis=-2)
    )
    u = jax.random.uniform(ka, de.shape)
    m = jnp.where(metropolis_accept(de, teff, u), -1.0, 1.0)[..., None, :]
    xe = xe * m
    yo = yo * m

    # color B lines, against the updated A quarters
    de = bc * (
        jnp.sum(ye * (_spatial_field(wb, xe, sl.K) + hb), axis=-2)
        + jnp.sum(xo * (_spatial_field(wb, yo, sl.K) + hb), axis=-2)
    )
    u = jax.random.uniform(kb, de.shape)
    m = jnp.where(metropolis_accept(de, teff, u), -1.0, 1.0)[..., None, :]
    ye = ye * m
    xo = xo * m

    return xe, xo, ye, yo


def qmc_slice_energies_split(sl, xe, xo, ye, yo):
    """Classical energy of every Trotter slice, (..., P), from the split
    state (the benchmark readout, examples/santoro80.py:290-296)."""
    wa = sl.w_ab[:, 0]
    ha, hb = sl.h_ab[0], sl.h_ab[1]
    e_even = (
        jnp.sum(xe * _spatial_field(wa, ye, sl.K), axis=-1)
        + jnp.sum(ha * xe, axis=-1)
        + jnp.sum(hb * ye, axis=-1)
    )
    e_odd = (
        jnp.sum(yo * _spatial_field(wa, xo, sl.K), axis=-1)
        + jnp.sum(ha * yo, axis=-1)
        + jnp.sum(hb * xo, axis=-1)
    )
    e = jnp.stack([e_even, e_odd], axis=-1)  # (..., P/2, 2)
    return e.reshape(e.shape[:-2] + (e.shape[-2] * 2,))


def qmc_split_kinetic(sl, xe, xo, ye, yo):
    """Trotter kinetic term K(x) = sum_{i,k} s_i^k s_i^{k+1} (periodic)
    from the split state, shape (...,). Color A sites sit at even slices
    in xe and odd in yo, so the adjacent pairs are (2j, 2j+1) = xe[j]*yo[j]
    and (2j+1, 2j+2 mod P) = yo[j]*xe[j+1 mod P/2]; color B likewise with
    (ye, xo). Used by quantum parallel tempering's exchange acceptance
    (solvers/pt.py)."""
    ka = jnp.sum(xe * yo, axis=(-1, -2)) + jnp.sum(
        yo * jnp.roll(xe, -1, axis=-2), axis=(-1, -2)
    )
    kb = jnp.sum(ye * xo, axis=(-1, -2)) + jnp.sum(
        xo * jnp.roll(ye, -1, axis=-2), axis=(-1, -2)
    )
    return ka + kb


# --------------------------------------------------------- dissipative PIQMC
#
# The bath term couples every slice pair of one spin line (qmc.pyx:269-273),
# so slices update sequentially (ops/piqmc.py module docstring) — but each
# slice update is two maskless half-phases, and a spin line lives entirely
# in ONE half (the checkerboard color is a property of the site, not the
# slice), so the bath matvec and the Trotter ring never cross halves.
# Layout: plain per-slice halves (a, b), each (..., P, Nh), via
# pack_classical on the (..., P, N) state (takes along axis -1).


def qmc_bath_split_sweep(sl, a, b, key, temp, gamma, bcur, bath_mat):
    """Slice-sequential dissipative sweep on split halves — the split form
    of piqmc.dissipative_local_sweep (qmc.pyx:149-278). Slices are visited
    in order 0..P-1 (the reference's slice loop, qmc.pyx:99); within a
    slice, half A updates then half B against the fresh A."""
    slices = a.shape[-2]
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    bc = -2.0 * bcur
    wa, ha = sl.w_ab[:, 0], sl.h_ab[0]
    wb, hb = sl.w_ab[:, 1], sl.h_ab[1]
    ka, kb = jax.random.split(key)
    ua = jax.random.uniform(ka, a.shape)
    ub = jax.random.uniform(kb, b.shape)

    def at(x, k):
        return jax.lax.dynamic_index_in_dim(x, k, axis=-2, keepdims=False)

    def slice_body(k, state):
        a, b = state
        up, dn = (k - 1) % slices, (k + 1) % slices
        # Bath field for slice k: row k of the (P, P) matrix against the
        # same half's lines (zero diagonal excludes the slice itself).
        row = jnp.take(bath_mat, k, axis=0)
        bath_a = jnp.einsum("p,...pn->...n", row, a,
                            precision=BATH_PRECISION)
        bath_b = jnp.einsum("p,...pn->...n", row, b,
                            precision=BATH_PRECISION)
        a_k, b_k = at(a, k), at(b, k)
        a_tr = at(a, up) + at(a, dn)
        b_tr = at(b, up) + at(b, dn)
        de = (
            bc * a_k * (_spatial_field(wa, b_k, sl.K) + ha)
            + 2.0 * a_k * jp * a_tr
            + 2.0 * teff * a_k * bath_a
        )
        a_k = jnp.where(metropolis_accept(de, teff, at(ua, k)), -a_k, a_k)
        de = (
            bc * b_k * (_spatial_field(wb, a_k, sl.K) + hb)
            + 2.0 * b_k * jp * b_tr
            + 2.0 * teff * b_k * bath_b
        )
        b_k = jnp.where(metropolis_accept(de, teff, at(ub, k)), -b_k, b_k)
        a = jax.lax.dynamic_update_index_in_dim(a, a_k, k, axis=-2)
        b = jax.lax.dynamic_update_index_in_dim(b, b_k, k, axis=-2)
        return a, b

    return jax.lax.fori_loop(0, slices, slice_body, (a, b))


def qmc_bath_split_global(sl, a, b, key, temp, bcur):
    """Whole-line flips on the per-slice halves layout. A full-line flip
    leaves both the J_perp chain terms AND the bath term invariant (both
    are bilinear in the line's own slices), so dE is the intra-slice sum
    only — the reference's bath omission at qmc.pyx:576-609 is exact."""
    slices = a.shape[-2]
    teff = temp * slices
    bc = -2.0 * bcur
    ka, kb = jax.random.split(key)

    de = bc * jnp.sum(
        a * (_spatial_field(sl.w_ab[:, 0], b, sl.K) + sl.h_ab[0]), axis=-2
    )
    u = jax.random.uniform(ka, de.shape)
    m = jnp.where(metropolis_accept(de, teff, u), -1.0, 1.0)[..., None, :]
    a = a * m
    de = bc * jnp.sum(
        b * (_spatial_field(sl.w_ab[:, 1], a, sl.K) + sl.h_ab[1]), axis=-2
    )
    u = jax.random.uniform(kb, de.shape)
    m = jnp.where(metropolis_accept(de, teff, u), -1.0, 1.0)[..., None, :]
    b = b * m
    return a, b


def _bath_quarter_mats(bath_mat):
    """Split the (P, P) bath matrix into the four (Q, Q) even/odd-slice
    blocks consumed by the quarter layout."""
    return (
        bath_mat[0::2, 0::2],  # ee
        bath_mat[0::2, 1::2],  # eo
        bath_mat[1::2, 0::2],  # oe
        bath_mat[1::2, 1::2],  # oo
    )


def qmc_bath_split_colored_sweep(sl, xe, xo, ye, yo, key, temp, gamma, bcur,
                                 bath_mat):
    """Space-time colored sweep + per-update bath snapshot on the quarter
    layout — the split form of piqmc.dissipative_colored_sweep (fast,
    approximate; see that docstring for the validated bias bounds).

    A line of an A site interleaves (xe, yo); of a B site, (ye, xo). The
    bath field for each quarter is two (Q, Q) matvecs against its line's
    quarters, recomputed from the live state before each quarter update
    (finer-grained than the masked form's per-phase snapshot)."""
    slices = 2 * xe.shape[-2]
    teff = temp * slices
    jp = jperp_of(gamma, teff)
    bc = -2.0 * bcur
    wa, ha = sl.w_ab[:, 0], sl.h_ab[0]
    wb, hb = sl.w_ab[:, 1], sl.h_ab[1]
    mee, meo, moe, moo = _bath_quarter_mats(bath_mat)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def bath(m_even, a_even, m_odd, a_odd):
        return jnp.einsum(
            "qp,...pn->...qn", m_even, a_even, precision=BATH_PRECISION
        ) + jnp.einsum(
            "qp,...pn->...qn", m_odd, a_odd, precision=BATH_PRECISION
        )

    def upd(s, f_sp_h, tr, bf, k):
        de = bc * s * f_sp_h + 2.0 * s * jp * tr + 2.0 * teff * s * bf
        u = jax.random.uniform(k, s.shape)
        return jnp.where(metropolis_accept(de, teff, u), -s, s)

    xe = upd(xe, _spatial_field(wa, ye, sl.K) + ha,
             yo + jnp.roll(yo, 1, axis=-2), bath(mee, xe, meo, yo), k1)
    xo = upd(xo, _spatial_field(wb, yo, sl.K) + hb,
             ye + jnp.roll(ye, -1, axis=-2), bath(moe, ye, moo, xo), k2)
    ye = upd(ye, _spatial_field(wb, xe, sl.K) + hb,
             xo + jnp.roll(xo, 1, axis=-2), bath(mee, ye, meo, xo), k3)
    yo = upd(yo, _spatial_field(wa, xo, sl.K) + ha,
             xe + jnp.roll(xe, -1, axis=-2), bath(moe, xe, moo, yo), k4)
    return xe, xo, ye, yo


def qmc_bath_anneal_split(problem, a_sched, b_sched, temp, confs, key,
                          lookuptable, global_moves=False,
                          collect_energy=False, bath_update="sequential",
                          state_dtype=jnp.bfloat16):
    """Split-layout dissipative PIQMC anneal scan — the fast inner engine
    for solvers.qmc.anneal(lookuptable=...) on even-L lattices with even P
    (qmc.DissipativeQuantumAnneal[Global], qmc.pyx:149-278, 444-609).

    bath_update="sequential" (default) keeps the reference's exact
    slice-sequential order on the per-slice halves layout;
    "colored" runs the approximate snapshot-bath colored sweep on the
    quarter layout (no sequential slice loop — see
    qmc_bath_split_colored_sweep / piqmc.dissipative_colored_sweep for
    the validated bias bounds).

    state_dtype: storage dtype of the spin-state scan carry; the bath
    einsums and every dE contraction promote to float32, so bfloat16
    (default) is bitwise-identical to float32 at half the carry
    footprint (see qmc_anneal_split)."""
    from montecarlosolvers_tpu.ops.piqmc import bath_matrix

    sl = build_split(problem)
    in_dtype = confs.dtype
    slices = confs.shape[-2]
    bath_mat = bath_matrix(lookuptable, slices)
    keys = jax.random.split(key, a_sched.shape[0])

    if bath_update == "colored":
        state = tuple(q.astype(state_dtype) for q in pack_qmc(sl, confs))

        def body(state, xs):
            gamma, bcur, k = xs
            k1, k2 = jax.random.split(k)
            state = qmc_bath_split_colored_sweep(
                sl, *state, k1, temp, gamma, bcur, bath_mat
            )
            if global_moves:
                state = qmc_split_global(sl, *state, k2, temp, bcur)
            e = (
                jnp.min(qmc_slice_energies_split(sl, *state), axis=-1)
                if collect_energy
                else None
            )
            return state, e

        state, es = jax.lax.scan(body, state, (a_sched, b_sched, keys))
        return unpack_qmc(sl, *(q.astype(in_dtype) for q in state)), es

    a, b = (q.astype(state_dtype) for q in pack_classical(sl, confs))

    def body(state, xs):
        gamma, bcur, k = xs
        k1, k2 = jax.random.split(k)
        a, b = qmc_bath_split_sweep(sl, *state, k1, temp, gamma, bcur,
                                    bath_mat)
        if global_moves:
            a, b = qmc_bath_split_global(sl, a, b, k2, temp, bcur)
        e = (
            jnp.min(classical_energy_split(sl, a, b), axis=-1)
            if collect_energy
            else None
        )
        return (a, b), e

    (a, b), es = jax.lax.scan(body, (a, b), (a_sched, b_sched, keys))
    return unpack_classical(sl, a.astype(in_dtype), b.astype(in_dtype)), es


def qmc_anneal_split(problem, a_sched, b_sched, temp, confs, key,
                     global_moves=False, collect_energy=False,
                     state_dtype=jnp.bfloat16):
    """Split-layout PIQMC anneal scan — the fast inner engine for
    solvers.qmc.anneal (open-boundary even-L lattice, even P, no bath).

    state_dtype: storage dtype of the scan carry (the four quarter
    arrays). Spins are exactly +/-1 and every dE/energy contraction
    promotes to float32 before touching the float32 couplings (the
    spatial field is roll-based elementwise, no matrix product), so
    bfloat16 storage produces BITWISE-identical trajectories to float32
    (regression-tested) while halving the bytes the carry moves per
    sweep. Pass jnp.float32 to opt out."""
    sl = build_split(problem)
    in_dtype = confs.dtype
    state = tuple(q.astype(state_dtype) for q in pack_qmc(sl, confs))
    keys = jax.random.split(key, a_sched.shape[0])

    def body(state, xs):
        gamma, bcur, k = xs
        k1, k2 = jax.random.split(k)
        state = qmc_split_sweep(sl, *state, k1, temp, gamma, bcur)
        if global_moves:
            state = qmc_split_global(sl, *state, k2, temp, bcur)
        e = (
            jnp.min(qmc_slice_energies_split(sl, *state), axis=-1)
            if collect_energy
            else None
        )
        return state, e

    state, es = jax.lax.scan(body, state, (a_sched, b_sched, keys))
    state = tuple(q.astype(in_dtype) for q in state)
    return unpack_qmc(sl, *state), es
