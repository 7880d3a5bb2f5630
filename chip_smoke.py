"""Smoke test of the annealing main path on one GPU.

Drives the system through the entry points a user calls — the CLI and
`solve()` — at the benchmark's widths: the seeded 80x80 lattice
`instances.random_2d_lattice(80, rng=0, lattice=True)` (N = 6400) and the
SK model `instances.sk_model(1024, rng=0)` (the dense engine). Every
result is checked against the repository's plain references
(montecarlosolvers_tpu/reference.py). Phases:

  device      platform, device kind and count, versions, XLA_FLAGS, the
              compile cache and the card (nvidia-smi, in a child process
              that does not touch JAX); fails unless JAX's devices are GPUs
  entry       the CLI (`__main__.main`, in this process) on a triplet file
  solve       every solve() method on the lattice, sa/pt/pa on SK: energies
              against float64 NumPy, compile and warm wall times
  bench       the four engines bench.py times, at its widths: one anneal,
              attempts/s, memory, and the same call on the CPU (16 chains);
              SA under threefry and rbg; bench.py's cluster arm; the bath
              engine with and without its HIGHEST precision pin
  reference   sequential NumPy oracles, exact-Gibbs histograms of the
              split SA sweep and the FK (Wolff) cluster update, and the
              dense local field and energy at full float32

With --four-cards only the multi-device path runs: chain-sharded SA and
PIQMC against the one-card run, the Trotter-sharded anneal against the
single-device engine, and the dry-run assertions of __graft_entry__.

One process drives the card(s); nothing else may open them. Prints one
line per check; exits non-zero when JAX finds no GPU or any check fails;
the last line is {"ok": true, "device": {"platform", "kind", "count"}}.

    python chip_smoke.py
    python chip_smoke.py --four-cards
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

# solve() method -> (lattice sweeps, kwargs); small counts keep the warm
# script within minutes (cluster presets compile slowly)
SOLVE_PRESETS = {
    "sa": (200, {}),
    "sa_wolff": (20, {}),
    "sa_sw": (20, {}),
    "piqmc": (50, {"slices": 8}),
    "piqmc_wolff": (10, {"slices": 8}),
    "piqmc_sw": (10, {"slices": 8}),
    "piqmc_sw_full": (10, {"slices": 8}),
    "svmc": (200, {}),
    "pt": (50, {}),
    "icm": (20, {}),
    "pa": (50, {}),
    "paq": (20, {"slices": 8}),
}
DENSE_METHODS = ("sa", "pt", "pa")
ENERGY_TOL = 1e-5      # |dE|/N between solve()'s float32 energies and float64
FIELD_TOL = 1e-5       # dense field/energy relative error at full float32
SE_BOUND = 4.0         # standard errors allowed between two samplers' means


class Report:
    """Prints one line per check and remembers whether any failed."""

    def __init__(self):
        self.failed = []

    def __call__(self, phase, ok, **fields):
        ok = bool(ok)
        if not ok:
            self.failed.append(phase)
        text = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"{'PASS' if ok else 'FAIL'} [{phase}] {text}", flush=True)
        return ok

    def run(self, phase, fn, *args, **kw):
        """Run a phase; an exception fails it (and so the script)."""
        try:
            return fn(self, *args, **kw)
        except Exception as e:  # noqa: BLE001 - recorded as a failed phase
            traceback.print_exc()
            return self(phase, False, error=repr(e)[:300])


def _fmt(v):
    if isinstance(v, float):
        return repr(float(v))
    if isinstance(v, dict):
        return json.dumps(v, default=str)
    return str(v)


def within_se(x, y, k=SE_BOUND):
    """(|mean(x) - mean(y)|, k standard errors of that difference)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    se = np.sqrt(x.var(ddof=1) / x.size + y.var(ddof=1) / y.size)
    return float(abs(x.mean() - y.mean())), float(k * se)


def lattice(L, generic=False):
    """The seeded benchmark lattice and its 0-indexed triplets."""
    from montecarlosolvers_tpu.models import instances

    return instances.random_2d_lattice(L, rng=0, lattice=not generic)


# --------------------------------------------------------------------------
# device
# --------------------------------------------------------------------------

def device_phase(report):
    import jax
    import jaxlib
    from montecarlosolvers_tpu.utils import device
    from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

    cache = enable_persistent_cache()
    info = device.describe()
    report("device", info["platform"] == "gpu", **info,
           jax=jax.__version__, jaxlib=jaxlib.__version__,
           XLA_FLAGS=os.environ.get("XLA_FLAGS", ""),
           JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", ""),
           compile_cache=cache)
    print(f"card: {device.card()}", flush=True)
    return info


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def entry_phase(report, L=80, reads=8, sweeps=50, slices=8):
    """CLI `solve` on a triplet file; best_energy against float64 NumPy."""
    from montecarlosolvers_tpu.__main__ import main as cli
    from montecarlosolvers_tpu.models import instances
    from montecarlosolvers_tpu.reference import triplet_energy

    _, (rows, cols, vals) = lattice(L)
    with tempfile.TemporaryDirectory() as d:
        inst, out = os.path.join(d, "lattice.txt"), os.path.join(d, "out.npz")
        instances.save_triplets(inst, rows, cols, vals)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli(["solve", inst, "--method", "piqmc", "--lattice", str(L),
                      "--num-reads", str(reads), "--sweeps", str(sweeps),
                      "--slices", str(slices), "--out", out])
        wall = time.perf_counter() - t0
        printed = json.loads(buf.getvalue().strip().splitlines()[-1])
        with np.load(out) as f:
            samples, energies = f["samples"], f["energies"]
    e64 = triplet_energy(samples, rows, cols, vals)
    n = L * L
    err = max(abs(printed["best_energy"] - e64.min()),
              float(np.max(np.abs(energies - e64)))) / n
    return report("entry", rc == 0 and err <= ENERGY_TOL,
                  cli="solve --method piqmc", rc=rc, reads=len(samples),
                  best_energy=printed["best_energy"],
                  numpy_best=float(e64.min()), max_dE_per_spin=err,
                  tol=ENERGY_TOL, wall_s=wall)


# --------------------------------------------------------------------------
# solve()
# --------------------------------------------------------------------------

def solve_check(report, problem, energy64, method, reads, sweeps, label,
                **kw):
    """solve() twice (compile + warm); energies against float64 NumPy."""
    from montecarlosolvers_tpu.solvers.api import solve

    t0 = time.perf_counter()
    solve(problem, method=method, num_reads=reads, sweeps=sweeps, seed=0, **kw)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve(problem, method=method, num_reads=reads, sweeps=sweeps,
                seed=0, **kw)
    warm = time.perf_counter() - t0
    s = np.asarray(res.samples)
    spins_ok = (s.shape == (reads, problem.nspins)
                and set(np.unique(s)) <= {-1.0, 1.0})
    err = float(np.max(np.abs(res.energies - energy64(s)))) / problem.nspins
    return report(f"solve:{label}:{method}", spins_ok and err <= ENERGY_TOL,
                  reads=reads, sweeps=sweeps,
                  best_e_per_spin=res.best_energy / problem.nspins,
                  max_dE_per_spin=err, tol=ENERGY_TOL,
                  compile_s=first - warm, warm_s=warm)


def solve_phase(report, L=80, sk_n=1024, reads=16, presets=SOLVE_PRESETS,
                dense_methods=DENSE_METHODS):
    from montecarlosolvers_tpu.models import instances
    from montecarlosolvers_tpu.reference import dense_energy, triplet_energy

    problem, (rows, cols, vals) = lattice(L)
    ok = True
    for method, (sweeps, kw) in presets.items():
        ok &= report.run(f"solve:lattice{L}:{method}", solve_check, problem,
                         lambda s: triplet_energy(s, rows, cols, vals),
                         method, reads, sweeps, f"lattice{L}", **kw)
    sk, _ = instances.sk_model(sk_n, rng=0)
    J, h = np.asarray(sk.J), np.asarray(sk.h)
    for method in dense_methods:
        ok &= report.run(f"solve:sk{sk_n}:{method}", solve_check, sk,
                         lambda s: dense_energy(s, J, h), method, reads,
                         presets[method][0], f"sk{sk_n}")
    return ok


# --------------------------------------------------------------------------
# benchmark widths
# --------------------------------------------------------------------------

def bench_engines(problem, P=40, taus=(2000, 300, 1000, 200),
                  chains=(1280, 32, 256, 32)):
    """bench.py's four engines: name -> (init(key), run(state, key),
    energy_per_spin(out), attempts per call, chains)."""
    import jax.numpy as jnp
    from montecarlosolvers_tpu.solvers import sa, qmc, svmc
    from montecarlosolvers_tpu import schedules

    n = problem.nspins
    sa_tau, q_tau, v_tau, b_tau = taus
    c_sa, c_q, c_v, c_b = chains
    lut = schedules.bath_lookuptable(P, 1e-2)

    def field(tau):
        a = schedules.transverse_field(3.0, 1e-8, tau)
        return a, jnp.ones_like(a)

    def slice_energy(out):
        return qmc.best_slice_energy(problem, out) / n

    def q_init(c):
        return lambda key: qmc.replicate(sa.random_state(key, n, batch=(c,)), P)

    sched = schedules.linear(3.0, 0.0, sa_tau)
    aq, bq = field(q_tau)
    av, bv = field(v_tau)
    ab, bb = field(b_tau)
    return {
        "sa": (lambda key: sa.random_state(key, n, batch=(c_sa,)),
               lambda s, key: sa.anneal(problem, sched, s, key),
               lambda out: problem.energy(out) / n, n * c_sa * sa_tau, c_sa),
        "piqmc": (q_init(c_q),
                  lambda c, key: qmc.anneal(problem, aq, bq, 1.0 / P, c, key,
                                            global_moves=True),
                  slice_energy, n * P * c_q * q_tau, c_q),
        "svmc": (lambda key: svmc.random_state(key, n, batch=(c_v,)),
                 lambda th, key: svmc.anneal(problem, av, bv, 0.05, th, key,
                                             tf=True),
                 lambda out: problem.energy(svmc.z_projection(out)) / n,
                 n * c_v * v_tau, c_v),
        "piqmc_bath": (q_init(c_b),
                       lambda c, key: qmc.anneal(problem, ab, bb, 1.0 / P, c,
                                                 key, lookuptable=lut),
                       slice_energy, n * P * c_b * b_tau, c_b),
    }


def _memory(compiled):
    mem = compiled.memory_analysis()
    return {k: getattr(mem, k) for k in dir(mem) if k.endswith("_in_bytes")}


def time_engine(run, state, key):
    """Compile run(state, key), run it once warm, time a second run.
    Returns (out, compile_s, wall_s, memory analysis)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(state, key).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(state, key))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(state, key))
    return out, compile_s, time.perf_counter() - t0, _memory(compiled)


def bench_phase(report, card="", L=80, P=40, taus=(2000, 300, 1000, 200),
                chains=(1280, 32, 256, 32), cpu_chains=16):
    import jax

    problem, _ = lattice(L)
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        problem_cpu, _ = lattice(L)
        engines_cpu = bench_engines(problem_cpu, P, taus, chains)
    ok = True
    for name, (init, run, energy, work, c) in bench_engines(
            problem, P, taus, chains).items():
        key = jax.random.key(0)
        state = init(key)
        out, compile_s, wall, mem = time_engine(run, state, key)
        e_dev = np.asarray(energy(out))[:cpu_chains]
        stats = dev.memory_stats() or {}
        run_cpu, energy_cpu = engines_cpu[name][1], engines_cpu[name][2]
        state_cpu = jax.device_put(state[:cpu_chains], cpu)
        t0 = time.perf_counter()
        out_cpu = jax.block_until_ready(
            jax.jit(run_cpu)(state_cpu, jax.device_put(key, cpu)))
        cpu_s = time.perf_counter() - t0
        on_cpu = out_cpu.devices() == {cpu}
        e_cpu = np.asarray(energy_cpu(out_cpu))
        gap, bound = within_se(e_dev, e_cpu)
        same = np.all(np.asarray(out)[:cpu_chains].reshape(cpu_chains, -1)
                      == np.asarray(out_cpu).reshape(cpu_chains, -1), axis=1)
        ok &= report(f"bench:{name}", on_cpu and gap <= bound,
                     chains=c, attempts_per_s=work / wall, wall_s=wall,
                     compile_s=compile_s, card=card,
                     e_per_spin_gpu=float(e_dev.mean()),
                     e_per_spin_cpu=float(e_cpu.mean()),
                     gap=gap, bound_4se=bound,
                     bitwise_equal_chain_frac=float(same.mean()),
                     cpu_s=cpu_s, memory=mem,
                     peak_bytes_in_use=stats.get("peak_bytes_in_use"))
    return ok


def prng_phase(report, card="", L=80, tau=2000, chains=1280):
    """SA at bench width under threefry and under rbg (same compile path)."""
    import jax

    problem, _ = lattice(L)
    init, run, energy, work, _ = bench_engines(
        problem, taus=(tau, 1, 1, 1), chains=(chains, 1, 1, 1))["sa"]
    rates = {}
    for impl in ("threefry2x32", "rbg"):
        key = jax.random.key(0, impl=impl)
        out, compile_s, wall, _ = time_engine(run, init(key), key)
        rates[impl] = work / wall
        report(f"prng:{impl}", np.isfinite(np.asarray(energy(out))).all(),
               chains=chains, tau=tau, attempts_per_s=rates[impl],
               wall_s=wall, compile_s=compile_s, card=card)
    return rates


def cluster_phase(report, card="", L=80):
    """bench.py's cluster arm at P=40: ms per Wolff cluster and per SW
    sweep. Their while_loops have data-dependent trip counts."""
    import bench

    problem, _ = lattice(L)
    out = bench._cluster_arm(problem)
    times = [v for k, v in out.items() if k.endswith(("_ms", "_per_chain"))]
    return report("cluster", len(times) == 4 and all(
        np.isfinite(t) and t > 0 for t in times), **out, card=card)


@contextlib.contextmanager
def bath_precision(precision):
    """Run the bath contractions at `precision` instead of the pinned
    HIGHEST (for measuring what the pin costs)."""
    import jax
    from montecarlosolvers_tpu.ops import piqmc, split

    saved = split.BATH_PRECISION
    split.BATH_PRECISION = piqmc.BATH_PRECISION = precision
    jax.clear_caches()
    try:
        yield
    finally:
        split.BATH_PRECISION = piqmc.BATH_PRECISION = saved
        jax.clear_caches()


def bath_pin_phase(report, card="", L=80, P=40, tau=200, chains=32):
    """The bath arm's rate with and without the HIGHEST pin."""
    import jax

    problem, _ = lattice(L)
    rates = {}
    for label, precision in (("highest", jax.lax.Precision.HIGHEST),
                             ("default", jax.lax.Precision.DEFAULT)):
        with bath_precision(precision):
            init, run, energy, work, _ = bench_engines(
                problem, P, (1, 1, 1, tau), (1, 1, 1, chains))["piqmc_bath"]
            key = jax.random.key(0)
            out, _, wall, _ = time_engine(run, init(key), key)
            rates[label] = work / wall
            report(f"bath_precision:{label}",
                   np.isfinite(np.asarray(energy(out))).all(),
                   chains=chains, tau=tau, attempts_per_s=rates[label],
                   wall_s=wall, card=card)
    return rates


# --------------------------------------------------------------------------
# plain references
# --------------------------------------------------------------------------

def oracle_phase(report, L=16, sa_cfg=(300, 256), q_cfg=(8, 400, 100),
                 v_cfg=(300, 256)):
    """Sequential NumPy oracles against the engines: equal-sweep anneal
    transients within max(3 sigma, 0.5%) (tests/test_reference_equivalence)."""
    import jax
    import jax.numpy as jnp
    from montecarlosolvers_tpu.models import instances
    from montecarlosolvers_tpu.models.lattice import LatticeProblem
    from montecarlosolvers_tpu import reference as ref
    from montecarlosolvers_tpu.solvers import sa, qmc, svmc

    gprob, (rows, cols, vals) = instances.random_2d_lattice(
        L, rng=np.random.default_rng(42))
    lprob = LatticeProblem.from_edges(L, rows, cols, vals)
    nbr_idx, nbr_J, h = (np.asarray(gprob.nbr_idx), np.asarray(gprob.nbr_J),
                         np.asarray(gprob.h))
    n = gprob.nspins

    def check(label, e_seq, e_ours, seconds):
        gap, bound, ratio = ref.transient_gap(e_seq, e_ours)
        return report(f"oracle:{label}", gap < bound and 0.4 < ratio < 2.5,
                      oracle_mean=float(e_seq.mean()),
                      engine_mean=float(e_ours.mean()), gap=gap,
                      bound=bound, std_ratio=ratio, oracle_s=seconds)

    ok = True
    tau, reps = sa_cfg
    sched = np.linspace(2.5, 0.0, tau)
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    s = ref.sequential_anneal(rng, rng.choice([-1.0, 1.0], size=(reps, n)),
                              nbr_idx, nbr_J, h, sched)
    e_seq = ref.triplet_energy(s, rows, cols, vals)
    secs = time.perf_counter() - t0
    key = jax.random.key(3)
    out = sa.anneal(gprob, jnp.asarray(sched, jnp.float32),
                    sa.random_state(key, n, batch=(reps,)), key)
    ok &= check("sa", e_seq, np.asarray(gprob.energy(out)), secs)

    P, tau, reps = q_cfg
    a_np, b_np = np.linspace(2.5, 1e-8, tau), np.ones(tau)
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    confs = ref.sequential_piqmc_anneal(
        rng, np.repeat(rng.choice([-1.0, 1.0], size=(reps, 1, n)), P, axis=1),
        nbr_idx, nbr_J, h, a_np, b_np, 1.0 / P)
    e_seq = ref.triplet_energy(confs, rows, cols, vals).min(axis=-1)
    secs = time.perf_counter() - t0
    confs0 = qmc.replicate(
        sa.random_state(jax.random.key(29), n, batch=(reps,)), P)
    for name, prob in (("piqmc_generic", gprob), ("piqmc_split", lprob)):
        out = qmc.anneal(prob, jnp.asarray(a_np, jnp.float32),
                         jnp.asarray(b_np, jnp.float32), 1.0 / P, confs0,
                         jax.random.key(31), global_moves=True)
        ok &= check(name, e_seq,
                    np.asarray(qmc.best_slice_energy(gprob, out)), secs)

    tau, reps = v_cfg
    a_np, b_np = np.linspace(2.5, 1e-8, tau), np.ones(tau)
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    th = ref.sequential_svmc_anneal(rng, rng.random((reps, n)) * np.pi,
                                    nbr_idx, nbr_J, h, a_np, b_np, 0.05)
    e_seq = ref.triplet_energy(np.where(np.cos(th) >= 0, 1.0, -1.0),
                               rows, cols, vals)
    secs = time.perf_counter() - t0
    out = svmc.anneal(gprob, jnp.asarray(a_np, jnp.float32),
                      jnp.asarray(b_np, jnp.float32), 0.05,
                      svmc.random_state(jax.random.key(17), n, batch=(reps,)),
                      jax.random.key(19))
    ok &= check("svmc", e_seq,
                np.asarray(gprob.energy(svmc.z_projection(out))), secs)
    return ok


def gibbs_phase(report, chains=64, sa_steps=(1500, 200),
                wolff_steps=(3000, 300)):
    """Exact-Gibbs histograms: the split SA sweep on a periodic 2x2 lattice
    (max |p - p_exact| < 0.01) and the FK Wolff cluster update on two
    spins x 2 slices (TV < 0.02) — the tests' bars."""
    import jax
    from montecarlosolvers_tpu.models.ising import IsingProblem
    from montecarlosolvers_tpu.models.lattice import LatticeProblem
    from montecarlosolvers_tpu.ops import cluster, split
    from montecarlosolvers_tpu import reference as ref
    from montecarlosolvers_tpu.solvers import sa

    rng = np.random.default_rng(7)
    lat = LatticeProblem.from_planes(rng.normal(size=(2, 2)),
                                     rng.normal(size=(2, 2)), None)
    sl = split.build_split(lat)
    temp = 1.2
    es = np.asarray(lat.energy(ref.enumerate_states(4, 1)[:, 0]))
    p_exact = np.exp(-es / temp) / np.exp(-es / temp).sum()

    def sa_step(s, k):
        return split.unpack_classical(
            sl, *split.sa_split_sweep(sl, *split.pack_classical(sl, s), k, temp))

    nsteps, burn = sa_steps
    p_emp = ref.state_histogram(
        sa_step, sa.random_state(jax.random.key(0), 4, batch=(chains,)),
        jax.random.key(1), nsteps, burn)
    err = float(np.max(np.abs(p_emp - p_exact)))
    ok = report("gibbs:split_sa", err < 0.01, max_abs_dp=err, tol=0.01)

    prob = IsingProblem.from_edges(2, [0], [1], [0.9], maxnb=2)
    slices, temp, gamma = 2, 0.8, 0.7
    states = ref.enumerate_states(2, slices)
    e = np.asarray(ref.extended_energy(prob, states, temp, gamma))
    p_exact = np.exp(-e / (temp * slices))
    p_exact /= p_exact.sum()
    upd = jax.vmap(lambda c, k: cluster.wolff_update(
        prob, c, k, temp, gamma, 1.0, rule="local"))
    nsteps, burn = wolff_steps
    confs0 = jax.numpy.where(
        jax.random.bernoulli(jax.random.key(0), 0.5, (chains, slices, 2)),
        1.0, -1.0)
    p_emp = ref.state_histogram(
        lambda c, k: upd(c, jax.random.split(k, c.shape[0])), confs0,
        jax.random.key(1), nsteps, burn)
    tv = float(0.5 * np.abs(p_emp - p_exact).sum())
    return ok & report("gibbs:wolff_fk", tv < 0.02, tv=tv, tol=0.02)


def dense_field_phase(report, n=1024, reads=64):
    """DenseProblem local fields and energies against float64 NumPy, at the
    pinned precision; the unpinned (DEFAULT) contraction is printed for
    the record."""
    import jax
    import jax.numpy as jnp
    from montecarlosolvers_tpu.models import instances
    from montecarlosolvers_tpu.reference import dense_energy
    from montecarlosolvers_tpu.solvers import sa

    sk, _ = instances.sk_model(n, rng=0)
    s = sa.random_state(jax.random.key(5), n, batch=(reads,))
    J, h, s64 = (np.asarray(sk.J, np.float64), np.asarray(sk.h, np.float64),
                 np.asarray(s, np.float64))
    f64 = s64 @ J + h
    e64 = dense_energy(s64, J, h)

    def rel(x, ref64):
        return float(np.max(np.abs(np.asarray(x, np.float64) - ref64))
                     / np.max(np.abs(ref64)))

    f_default = jnp.einsum("...n,nm->...m", s, sk.J,
                           precision=jax.lax.Precision.DEFAULT) + sk.h
    field_err, energy_err = rel(sk.local_fields(s), f64), rel(sk.energy(s), e64)
    return report("dense_fields", max(field_err, energy_err) <= FIELD_TOL,
                  n=n, field_rel_err=field_err, energy_rel_err=energy_err,
                  tol=FIELD_TOL, field_rel_err_default_precision=rel(
                      f_default, f64))


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def four_card_phase(report, n_dev=4, L=80, sa_cfg=(1280, 200),
                    q_cfg=(40, 32, 100), trotter_cfg=(40, 32, 100)):
    """Chain-sharded SA and PIQMC bitwise against one card; the
    Trotter-sharded anneal (replica=n_dev) within 4 standard errors of the
    single-device engine; then __graft_entry__'s dry-run assertions."""
    import jax
    import jax.numpy as jnp
    import __graft_entry__
    from montecarlosolvers_tpu.parallel import make_mesh, shard_chains, trotter
    from montecarlosolvers_tpu.solvers import sa, qmc
    from montecarlosolvers_tpu import schedules

    if len(jax.devices()) < n_dev:
        return report("four_cards", False, devices=len(jax.devices()),
                      needed=n_dev)
    problem, _ = lattice(L)
    n = problem.nspins
    mesh = make_mesh(chains=n_dev)
    key = jax.random.key(0)
    ok = True

    def timed(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return np.asarray(out), time.perf_counter() - t0

    chains, tau = sa_cfg
    s0 = sa.random_state(key, n, batch=(chains,))
    sched = schedules.linear(3.0, 0.0, tau)
    one, t1 = timed(lambda: sa.anneal(problem, sched, s0, key))
    many, t4 = timed(lambda: sa.anneal(problem, sched, shard_chains(s0, mesh), key))
    ok &= report("four_cards:sa_chain_sharded", np.array_equal(one, many),
                 chains=chains, tau=tau, bitwise=np.array_equal(one, many),
                 one_card_s=t1, sharded_s=t4)

    P, chains, tau = q_cfg
    confs = qmc.replicate(sa.random_state(key, n, batch=(chains,)), P)
    a = schedules.transverse_field(3.0, 1e-8, tau)
    b = jnp.ones_like(a)
    one, t1 = timed(lambda: qmc.anneal(problem, a, b, 1.0 / P, confs, key,
                                       global_moves=True))
    many, t4 = timed(lambda: qmc.anneal(problem, a, b, 1.0 / P,
                                        shard_chains(confs, mesh), key,
                                        global_moves=True))
    ok &= report("four_cards:piqmc_chain_sharded", np.array_equal(one, many),
                 P=P, chains=chains, tau=tau,
                 bitwise=np.array_equal(one, many), one_card_s=t1,
                 sharded_s=t4)

    P, chains, tau = trotter_cfg
    gprob, _ = lattice(L, generic=True)
    confs = qmc.replicate(sa.random_state(key, n, batch=(chains,)), P)
    a = schedules.transverse_field(3.0, 1e-8, tau)
    b = jnp.ones_like(a)
    one, t1 = timed(lambda: qmc.anneal(gprob, a, b, 1.0 / P, confs, key,
                                       global_moves=True))
    rmesh = make_mesh(replica=n_dev)
    many, t4 = timed(lambda: trotter.anneal_sharded(
        gprob, a, b, 1.0 / P, confs, jax.random.key(1), rmesh,
        global_moves=True))
    e1 = np.asarray(qmc.best_slice_energy(gprob, jnp.asarray(one))) / n
    e4 = np.asarray(qmc.best_slice_energy(gprob, jnp.asarray(many))) / n
    gap, bound = within_se(e1, e4)
    ok &= report("four_cards:trotter_sharded", gap <= bound, P=P,
                 chains=chains, tau=tau, e_per_spin_one=float(e1.mean()),
                 e_per_spin_sharded=float(e4.mean()), gap=gap,
                 bound_4se=bound, one_card_s=t1, sharded_s=t4)

    t0 = time.perf_counter()
    __graft_entry__._dryrun_impl(n_dev)
    return ok & report("four_cards:dryrun_assertions", True, n_devices=n_dev,
                       wall_s=time.perf_counter() - t0)


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path, on four GPUs")
    args = ap.parse_args(argv)

    report = Report()
    info = report.run("device", device_phase)
    if not isinstance(info, dict) or info["platform"] != "gpu":
        found = info["platform"] if isinstance(info, dict) else "none"
        print(f"chip_smoke: no GPU (JAX found platform {found!r}); nothing "
              "was measured", file=sys.stderr)
        return 1
    from montecarlosolvers_tpu.utils import device

    card = device.card()
    t0 = time.perf_counter()
    if args.four_cards:
        report.run("four_cards", four_card_phase)
    else:
        for phase, fn, kw in (
            ("entry", entry_phase, {}),
            ("solve", solve_phase, {}),
            ("bench", bench_phase, {"card": card}),
            ("prng", prng_phase, {"card": card}),
            ("cluster", cluster_phase, {"card": card}),
            ("bath_precision", bath_pin_phase, {"card": card}),
            ("oracle", oracle_phase, {}),
            ("gibbs", gibbs_phase, {}),
            ("dense_fields", dense_field_phase, {}),
        ):
            report.run(phase, fn, **kw)
    print(f"card: {card}", flush=True)
    print(f"wall_s: {time.perf_counter() - t0!r}", flush=True)
    if report.failed:
        print(f"chip_smoke: failed: {', '.join(report.failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
