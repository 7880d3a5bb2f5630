"""Cluster-update crossover experiment: where Wolff clusters DO win.

Companion to cluster_value.py (the spin-glass equal-wall comparison, an
honest null: at the benchmark's coupling distribution the satisfied-bond
FK graph percolates and one cluster move buys ~540 local sweeps). The
null's closing prediction — "on problems where FK clusters stay
subcritical the crossover favors clusters" — is a measurable claim; this
experiment measures it at the textbook setting, the 2D ferromagnetic
critical point, where single-site dynamics suffers critical slowing-down
(z ~ 2.2) and Wolff clusters nearly eliminate it (z ~ 0.25).

Setup: L x L periodic ferromagnet (J = -1 under this package's
H = sum_ij J s_i s_j convention), PIQMC representation at small Gamma
and physical temperature temp = T: J_perp = -(T_eff/2) ln tanh(Gamma/
T_eff) locks the Trotter slices (temporal bond activation > 0.98), and a
locked line flips with exp(-P dE_cl / T_eff) = exp(-dE_cl / T) — the
Gamma -> 0 limit of the Suzuki-Trotter action is the CLASSICAL model at
temp itself (measured: m^2 matches a classical chain at T_c to < 0.01).
A WCL space-time cluster is then a classical Wolff cluster on the line
variables (qmc.pyx:620-786's algorithm, in its home regime). Both arms
share the same equilibrium measure, so the comparison is pure dynamics:

  * local+global: space-time colored sweeps + global line moves — the
    production arm from cluster_value.py.
  * +wolff: the same, plus one WCL cluster per chain per sweep.

Metric: integrated autocorrelation time tau_int of m^2 (m = space-time
magnetization; m^2 is Z2-even so it converges without waiting for global
sign flips), windowed per Sokal's self-consistent rule, averaged over
chains, converted to wall-clock per independent sample via the measured
per-step wall of each arm. Points: T = T_c (critical) and T = 1.5 T_c
(control, where local dynamics is fast and clusters should NOT pay).

`main_classical` adds the purely classical track (states (chains, N), no
Trotter axis): colored Metropolis vs classical Wolff (sa.anneal_wolff
engine) vs classical Swendsen-Wang — the latter in both labeler forms,
generic neighbor-table min-label relax ("sw") and LatticeProblem
segmented row/column min-scans ("swlat", ops/cluster.py
classical_sw_sweep_lattice), which propagate labels across whole
connected runs per round instead of one hop.

Writes results/cluster_value/crossover.json; resumes by arm name.
"""

from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.bench._common import make_recorder
from montecarlosolvers_tpu.models.ising import IsingProblem
from montecarlosolvers_tpu.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu.ops import cluster as cluster_ops

T_C = 2.0 / np.log(1.0 + np.sqrt(2.0))  # 2.269185 (Onsager)


def fm_lattice(L, lattice=False):
    """Periodic L x L ferromagnet: J = -1 on every bond (H = sum J s s).

    lattice=True returns the structured LatticeProblem (plane couplings),
    which routes SW sweeps to the segmented-scan labeler."""
    if lattice:
        from montecarlosolvers_tpu.models.lattice import LatticeProblem

        planes = -np.ones((L, L), np.float32)
        return LatticeProblem.from_planes(planes, planes.copy())
    rows, cols = [], []
    for r in range(L):
        for c in range(L):
            i = r * L + c
            rows.append(i)
            cols.append(r * L + (c + 1) % L)
            rows.append(i)
            cols.append(((r + 1) % L) * L + c)
    vals = -np.ones(len(rows))
    return IsingProblem.from_edges(L * L, rows, cols, vals, maxnb=4)


def tau_int(x, c=6.0):
    """Integrated autocorrelation time of a 1-D series, Sokal window:
    the smallest W with W >= c * tau_int(W)."""
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n = x.shape[0]
    f = np.fft.rfft(x, 2 * n)
    acf = np.fft.irfft(f * np.conj(f))[:n].real
    if acf[0] <= 0:
        return 0.5
    acf = acf / acf[0]
    tau = 0.5
    for w in range(1, n // 2):
        tau += acf[w]
        if w >= c * tau:
            break
    return max(tau, 0.5)


def run_arm(problem, temp, gamma, chains, nsweeps, key, wolff_every=0,
            chunk=2048, P=4, b=1.0, burn=2048):
    """Returns (tau_int sweeps, wall per sweep s, mean m^2, flip_frac)."""
    N = problem.nspins
    k0, key = jax.random.split(key)
    confs = jnp.where(
        jax.random.bernoulli(k0, 0.5, (chains, P, N)), 1.0, -1.0
    ).astype(jnp.float32)

    wolff_v = jax.vmap(
        lambda c, k: cluster_ops.wolff_update(
            problem, c, k, temp, gamma, b, rule="local")
    )

    @jax.jit
    def seg(confs, key, start):
        keys = jax.random.split(key, chunk)

        def body(carry, x):
            confs, i = carry
            k = x
            k1, k2, k3 = jax.random.split(k, 3)
            confs = piqmc_ops.local_sweep(problem, confs, k1, temp, gamma, b)
            confs = piqmc_ops.global_line_moves(problem, confs, k2, temp, b)
            if wolff_every:
                def with_cl(confs):
                    return wolff_v(confs, jax.random.split(k3, chains))
                new = jax.lax.cond(
                    i % wolff_every == 0, with_cl, lambda c: c, confs)
                frac = jnp.mean((new != confs).astype(jnp.float32))
                confs = new
            else:
                frac = jnp.float32(0.0)
            m = jnp.mean(confs, axis=(-1, -2))  # (chains,)
            return (confs, i + 1), (m * m, frac)

        (confs, _), (m2, frac) = jax.lax.scan(body, (confs, start), keys)
        return confs, m2, frac

    # burn-in (not timed, not collected)
    i = jnp.int32(0)
    for bseg in range(-(-burn // chunk)):
        key, kk = jax.random.split(key)
        confs, _, _ = seg(confs, kk, i)
        i = i + chunk
    jax.block_until_ready(confs)  # sync before the timed windows

    m2s, fracs, walls = [], [], []
    for _ in range(-(-nsweeps // chunk)):
        key, kk = jax.random.split(key)
        t0 = time.time()
        confs, m2, frac = seg(confs, kk, i)
        m2 = np.asarray(m2)  # the host fetch waits for the segment
        walls.append(time.time() - t0)
        m2s.append(m2)
        fracs.append(np.asarray(frac))
        i = i + chunk
    m2 = np.concatenate(m2s, axis=0)  # (nsweeps, chains)
    taus = [tau_int(m2[:, c]) for c in range(chains)]
    # min wall window
    wall_per_sweep = min(walls) / chunk
    return (
        float(np.mean(taus)),
        float(wall_per_sweep),
        float(m2.mean()),
        float(np.concatenate(fracs).mean()),
    )


def run_classical_arm(problem, temp, chains, nsweeps, key, move="local",
                      chunk=2048, burn=2048):
    """Purely classical arms on (chains, N) states: move in
    {"local" (colored Metropolis), "wolff" (one cluster/step),
     "sw" (full Swendsen-Wang sweep/step), "sw+local"}.
    Returns (tau_int sweeps, wall per sweep s, mean m^2)."""
    from montecarlosolvers_tpu.ops.metropolis import colored_metropolis_sweep
    from montecarlosolvers_tpu.ops import cluster as cluster_ops

    N = problem.nspins
    k0, key = jax.random.split(key)
    s = jnp.where(
        jax.random.bernoulli(k0, 0.5, (chains, N)), 1.0, -1.0
    ).astype(jnp.float32)
    t = jnp.float32(temp)

    wolff_v = jax.vmap(
        lambda c, k: cluster_ops.wolff_update(
            problem, c[None, :], k, t, jnp.inf, 1.0, rule="local")[0],
        in_axes=(0, 0))
    sw_v = jax.vmap(
        lambda c, k: cluster_ops.classical_sw_sweep(problem, c, k, t),
        in_axes=(0, 0))

    @jax.jit
    def seg(s, key):
        keys = jax.random.split(key, chunk)

        def body(s, k):
            k1, k2 = jax.random.split(k)
            if move in ("local", "sw+local"):
                s = colored_metropolis_sweep(problem, s, k1, t)
            if move == "wolff":
                s = wolff_v(s, jax.random.split(k2, chains))
            elif move in ("sw", "sw+local"):
                s = sw_v(s, jax.random.split(k2, chains))
            m = jnp.mean(s, axis=-1)
            return s, m * m

        return jax.lax.scan(body, s, keys)

    for _ in range(-(-burn // chunk)):
        key, kk = jax.random.split(key)
        s, _ = seg(s, kk)
    jax.block_until_ready(s)

    m2s, walls = [], []
    for _ in range(-(-nsweeps // chunk)):
        key, kk = jax.random.split(key)
        t0 = time.time()
        s, m2 = seg(s, kk)
        m2s.append(np.asarray(m2))
        walls.append(time.time() - t0)
    m2 = np.concatenate(m2s, axis=0)
    taus = [tau_int(m2[:, c]) for c in range(chains)]
    return float(np.mean(taus)), float(min(walls) / chunk), float(m2.mean())


def main(outdir="results/cluster_value", Ls=(32,), P=4, gamma=0.1, chains=16,
         nsweeps=16384, critical_only_above=32):
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "crossover.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)

    key = jax.random.key(0)

    record = make_recorder(path, done)

    for L in Ls:
        problem = fm_lattice(L)
        temps = [("critical", T_C), ("offcritical", 1.5 * T_C)]
        if L > critical_only_above:
            temps = temps[:1]  # the off-critical control needs one size
        for tag, T in temps:
            temp = T  # classical temperature of the locked-slice limit
            for arm, we in (("localglobal", 0), ("wolff1", 1), ("wolff4", 4)):
                name = f"{tag}_{arm}_L{L}"
                # cluster arms decorrelate in a few sweeps — a quarter
                # trace estimates their tau as well as the full trace
                # estimates the local arm's; at L=128 a critical cluster
                # sweep costs ~0.1-0.2 s (flip_frac ~0.4 of 4*L^2 sites),
                # so the cluster trace shrinks further and the burn drops
                # to ~100x its own tau (cluster arms equilibrate in a few
                # sweeps)
                if we == 0:
                    ns, bn = nsweeps, 2048
                elif L <= 64:
                    ns, bn = max(nsweeps // 4, 8192), 2048
                else:
                    ns, bn = 2048, 512
                # bound each device dispatch: cluster sweeps cost ~L*N
                # BFS work each, so larger lattices take shorter chunks
                ck = 2048 if (we == 0 or L <= 32) else (
                    256 if L <= 64 else 64
                )
                kp = jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
                record(name, lambda we=we, temp=temp, kp=kp, ns=ns,
                       ck=ck, bn=bn, problem=problem: dict(zip(
                    ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2",
                     "flip_frac"),
                    run_arm(problem, temp, gamma, chains, ns, kp,
                            wolff_every=we, P=P, chunk=ck, burn=bn),
                )))

    _summary(done)
    return done


def main_classical(outdir="results/cluster_value", Ls=(32, 64, 128),
                   chains=16, nsweeps=32768, wolff_max_L=64):
    """Classical track: colored Metropolis vs classical Wolff vs classical
    Swendsen-Wang (sa.anneal_wolff / sa.anneal_sw engines) on the FM
    lattice at T_c and 1.5 T_c."""
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "crossover.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    key = jax.random.key(42)

    record = make_recorder(path, done)

    for L in Ls:
        prob_gen = fm_lattice(L)
        prob_lat = fm_lattice(L, lattice=True)
        temps = [("critical", T_C)] + (
            [("offcritical", 1.5 * T_C)] if L == Ls[0] else [])
        for tag, T in temps:
            # "sw"/"sw+local" run the generic neighbor-table relax (the
            # labeler any graph gets); "swlat" runs the LatticeProblem
            # segmented-scan labeler — same measure, different cost
            moves = ["local", "sw", "sw+local", "swlat", "swlat+local"]
            if L <= wolff_max_L:
                moves.insert(1, "wolff")
            for move in moves:
                problem = prob_lat if move.startswith("swlat") else prob_gen
                name = f"cl_{tag}_{move}_L{L}"
                move = move.replace("swlat", "sw")
                ns = nsweeps if move == "local" else max(nsweeps // 4, 8192)
                # one Wolff BFS at L=128 would be ~0.2 s/sweep; SW stays
                # cheap (log-diameter label rounds), local is microseconds
                ck = 2048 if move in ("local",) else (
                    512 if move != "wolff" else 256)
                kp = jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
                record(name, lambda move=move, T=T, kp=kp, ns=ns, ck=ck,
                       problem=problem: dict(zip(
                    ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2"),
                    run_classical_arm(problem, T, chains, ns, kp,
                                      move=move, chunk=ck),
                )))
    _summary(done)
    return done


def main_L256(outdir="results/cluster_value", chains=16):
    """The decisive size: extrapolating the measured scalings (local cost
    ~ L^4.1 per sample, SW ~ L^3.1) puts the local/SW crossover between
    L=128 and L=256 — this runs the L=256 critical point. Wolff is
    skipped: one cluster costs the same relax depth as a full SW sweep
    and updates strictly less."""
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    enable_persistent_cache()
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "crossover.json")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            done = json.load(f)
    key = jax.random.key(7)
    problem = fm_lattice(256)

    record = make_recorder(path, done)

    # local: tau_int ~ 2500 sweeps at L=256 — the trace must cover many
    # tau; sw: tau ~ 5 but each sweep's relax depth grows ~ L^1.1, so its
    # dispatch chunks are kept small
    record("cl_critical_local_L256", lambda: dict(zip(
        ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2"),
        run_classical_arm(problem, T_C, chains, 98304,
                          jax.random.fold_in(key, 1), move="local",
                          chunk=2048, burn=16384))))
    record("cl_critical_sw_L256", lambda: dict(zip(
        ("tau_int_sweeps", "wall_per_sweep_s", "mean_m2"),
        run_classical_arm(problem, T_C, chains, 2048,
                          jax.random.fold_in(key, 2), move="sw",
                          chunk=64, burn=256))))
    _summary(done)
    return done


def _summary(done):
    # decorrelation cost summary: wall-clock per independent m^2 sample
    print("\n== wall per independent sample (tau_int * wall/sweep) ==")
    for name, r in done.items():
        cost = 2.0 * r["tau_int_sweeps"] * r["wall_per_sweep_s"]
        print(f"{name}: tau={r['tau_int_sweeps']:.1f} sweeps, "
              f"{1e3 * r['wall_per_sweep_s']:.3f} ms/sweep, "
              f"cost={1e3 * cost:.1f} ms/sample, m2={r['mean_m2']:.4f}")
    return done


if __name__ == "__main__":
    main()
