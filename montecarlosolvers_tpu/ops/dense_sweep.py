"""Blocked-sequential Metropolis sweep for dense problems (matmul engine).

The reference's sequential single-spin sweep (sa.pyx:81-99) is exact but
serial; the colored-parallel transform (ops/metropolis.py) needs sparse
structure. For fully-connected problems this module keeps the *sequential*
semantics but restructures the work into matrix products:

  * fields for a block of B spins = one (chains, N) x (N, B) matmul;
  * within the block, spins update one at a time, and each accepted flip
    applies a rank-1 "delayed update" to the remaining in-block fields
    (field_k += -2 s_i J_ik), so the sweep is bit-exact sequential
    Metropolis in systematic-scan order;
  * the next block's fields are recomputed fresh (all earlier flips are
    then reflected through the matmul).

Per sweep: N/B matmuls (O(C N^2) MACs) + N cheap vector
micro-steps — versus O(N) full-field recomputes for the degenerate colored
sweep. Exactness is validated by the dense Gibbs-histogram test.

Throughput scaling: the chain batch C is the free lever — the N
sequential micro-steps amortize over chains; every attempt touches all N
couplings. The block size B=128 and the chain counts have not been tuned
on the GPU yet.

Two options extend the engine:
  * shuffle=True — random-scan order (a fresh permutation per sweep),
    realized by permuting J/h/s up front so the matmul structure is kept;
  * matmul_dtype=jnp.bfloat16 — halves the bytes per field matmul;
    the sweep is then exact sequential Metropolis on the bf16-rounded
    problem (bitwise f32-identical when couplings are +/-1-valued).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from montecarlosolvers_tpu.ops.metropolis import metropolis_accept


def dense_metropolis_sweep(dp, s, key, temp, block=128, shuffle=False,
                           matmul_dtype=None):
    """One sequential Metropolis sweep (systematic or shuffled scan).

    dp: DenseProblem; s: (C, N) float32 +/-1; returns updated (C, N).

    shuffle: visit spins in a fresh uniform-random permutation each sweep
      (random-scan Metropolis) instead of systematic 0..N-1 order. The
      permutation is applied to J/h/s once up front (an O(N^2) gather,
      ~1/C of the sweep's matmul MACs) so the blocked-matmul structure is
      untouched; the update sequence is exactly sequential Metropolis in
      permuted order.

    matmul_dtype: storage/compute dtype for the J matmul and the in-block
      rank-1 delayed updates (e.g. jnp.bfloat16 for the tensor cores);
      accumulation stays float32 via preferred_element_type. The sweep is
      then EXACT sequential Metropolis on the dtype-rounded problem
      (J.astype(matmul_dtype)); for +/-1-valued couplings the rounding is
      lossless and trajectories are bitwise identical to float32.
    """
    C, N = s.shape
    B = min(block, N)
    nblocks = -(-N // B)
    pad = nblocks * B - N
    # pad J/h so every block is full; padded spins have zero couplings and
    # fields, so their (always-accepted, de=0) flips are inert
    J = dp.J
    h = dp.h
    if shuffle:
        kperm, key = jax.random.split(key)
        perm = jax.random.permutation(kperm, N)
        J = J[perm][:, perm]
        h = h[perm]
        s = s[:, perm]
    if matmul_dtype is not None:
        J = J.astype(matmul_dtype)
    if pad:
        J = jnp.pad(J, ((0, pad), (0, pad)))
        h = jnp.pad(h, (0, pad))
        s = jnp.pad(s, ((0, 0), (0, pad)), constant_values=1.0)
    Np = N + pad
    u = jax.random.uniform(key, (C, Np))
    sm = s.astype(J.dtype) if matmul_dtype is not None else s
    # float32 couplings need full float32 products (TF32 would round them
    # to about three digits); matmul_dtype is the explicit low-precision
    # route and keeps the default
    precision = lax.Precision.HIGHEST if matmul_dtype is None else None

    def block_body(bi, carry):
        s, sm = carry
        start = bi * B
        Jb = lax.dynamic_slice(J, (0, start), (Np, B))   # (Np, B)
        fb = (
            jnp.dot(sm if matmul_dtype is not None else s, Jb,
                    precision=precision,
                    preferred_element_type=jnp.float32)
            + lax.dynamic_slice(h, (start,), (B,))
        )  # (C, B)
        ub = lax.dynamic_slice(u, (0, start), (C, B))

        def inner(j, carry):
            s, sm, fb = carry
            i = start + j
            si = lax.dynamic_slice(s, (0, i), (C, 1))[:, 0]
            fi = fb[:, j]
            de = -2.0 * si * fi
            accept = metropolis_accept(de, temp, ub[:, j])
            s_new = jnp.where(accept, -si, si)
            s = lax.dynamic_update_slice(s, s_new[:, None], (0, i))
            if matmul_dtype is not None:
                sm = lax.dynamic_update_slice(
                    sm, s_new.astype(sm.dtype)[:, None], (0, i))
            # delayed update of remaining in-block fields: row i of Jb
            # (upcast so the rank-1 correction uses the same rounded
            # couplings the matmul saw)
            jrow = lax.dynamic_slice(Jb, (i, 0), (1, B))[0].astype(
                jnp.float32)  # (B,)
            fb = fb + (s_new - si)[:, None] * jrow[None, :]
            return s, sm, fb

        s, sm, _ = lax.fori_loop(0, B, inner, (s, sm, fb))
        return s, sm

    s, _ = lax.fori_loop(0, nblocks, block_body, (s, sm))
    if pad:
        s = s[:, :N]
    if shuffle:
        # undo the visit-order permutation: out[:, perm[i]] = s[:, i]
        s = jnp.zeros_like(s).at[:, perm].set(s)
    return s


@partial(jax.jit, static_argnames=("mcsteps", "block", "collect_energy",
                                   "shuffle", "matmul_dtype"))
def dense_anneal(dp, sched, s, key, mcsteps=1, block=128,
                 collect_energy=False, shuffle=False, matmul_dtype=None):
    """Thermal anneal on a DenseProblem (sequential-scan sweeps).

    s: (C, N) or (N,); returns same shape (+ optional per-sweep energies).
    shuffle / matmul_dtype: see dense_metropolis_sweep.
    """
    from montecarlosolvers_tpu import schedules as sched_mod

    # accept any (..., N) batch shape like the sparse path: flatten the
    # leading dims into the chain axis and restore at the end
    orig_shape = s.shape
    s = s.reshape(-1, orig_shape[-1]) if s.ndim != 2 else s
    temps = sched_mod.expand_mcsteps(sched, mcsteps)
    keys = jax.random.split(key, temps.shape[0])

    def body(s, x):
        t, k = x
        s = dense_metropolis_sweep(dp, s, k, t, block=block, shuffle=shuffle,
                                   matmul_dtype=matmul_dtype)
        return s, (dp.energy(s) if collect_energy else None)

    s, es = lax.scan(body, s, (temps, keys))
    s = s.reshape(orig_shape)
    if collect_energy:
        es = es.reshape((es.shape[0],) + orig_shape[:-1])
        return s, es
    return s
