"""High-level solve() API and the extra instance generators."""

import numpy as np
import jax.numpy as jnp
import pytest

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers.api import solve, SampleSet
from tests.test_sa import brute_force_ground


@pytest.fixture(scope="module")
def prob():
    p, _ = instances.random_2d_lattice(4, rng=np.random.default_rng(0))
    return p


class TestSolve:
    @pytest.mark.parametrize(
        "method", ["sa", "piqmc", "piqmc_wolff", "piqmc_sw", "svmc", "pt"]
    )
    def test_methods_reach_ground_state(self, prob, method):
        e_gs, _ = brute_force_ground(prob)
        kw = dict(slices=6) if method.startswith("piqmc") else {}
        if method == "piqmc_sw":
            kw["alpha"] = 1e-3
        if method == "pt":
            kw = dict(ladder=6)
        res = solve(prob, method=method, num_reads=16, sweeps=400, seed=1, **kw)
        assert isinstance(res, SampleSet)
        assert len(res) == 16
        assert np.all(np.diff(res.energies) >= 0)  # sorted
        tol = 0.1 * abs(e_gs)
        assert res.best_energy <= e_gs + tol, (method, res.best_energy, e_gs)
        assert set(np.unique(res.samples)) <= {-1.0, 1.0}

    def test_unknown_method(self, prob):
        with pytest.raises(ValueError):
            solve(prob, method="nope")

    def test_deterministic_given_seed(self, prob):
        a = solve(prob, num_reads=4, sweeps=50, seed=7)
        b = solve(prob, num_reads=4, sweeps=50, seed=7)
        assert np.array_equal(a.samples, b.samples)

    def test_piqmc_preset_beats_sa_at_equal_sweeps(self):
        """Quality regression on the presets (VERDICT item 8): at an equal
        Gamma/T sweep budget too short for SA to converge, the default
        piqmc preset must land a lower mean energy than sa — the MST
        ordering (examples/santoro80.py) at API-default settings."""
        p, _ = instances.random_2d_lattice(6, rng=np.random.default_rng(3))
        e_gs = None  # 36 spins: no enumeration; compare methods directly
        sweeps, reads = 120, 128
        r_sa = solve(p, method="sa", num_reads=reads, sweeps=sweeps, seed=5)
        r_q = solve(p, method="piqmc", num_reads=reads, sweeps=sweeps,
                    seed=5, slices=8)
        m_sa, m_q = r_sa.energies.mean(), r_q.energies.mean()
        se = np.sqrt(r_sa.energies.var() / reads + r_q.energies.var() / reads)
        assert m_q < m_sa - 2.0 * se, (m_q, m_sa, se)
        assert r_q.best_energy <= r_sa.best_energy + 1e-6


class TestGenerators:
    def test_sk_model(self):
        # default: dense matmul problem
        dp, (r, c, v) = instances.sk_model(12, rng=0)
        from montecarlosolvers_tpu.models.dense import DenseProblem

        assert isinstance(dp, DenseProblem)
        assert dp.nspins == 12
        assert len(r) == 12 * 11 // 2
        # sparse fallback for oracle/interop use
        prob, _ = instances.sk_model(12, rng=0, dense=False)
        assert prob.maxnb == 11
        # both agree on energies
        import jax.numpy as jnp

        s = jnp.asarray(np.random.default_rng(1).choice([-1.0, 1.0], size=12))
        assert np.isclose(float(dp.energy(s)), float(prob.energy(s)),
                          rtol=1e-4, atol=1e-4)

    def test_chimera(self):
        prob, (r, c, v) = instances.chimera_graph(2, 2, t=4, rng=0)
        assert prob.nspins == 2 * 2 * 8
        # intra-cell: 4 cells x 16; vertical: 2x4 between row pairs x 2 cols;
        # horizontal: 2x4 between col pairs x 2 rows
        assert len(r) == 4 * 16 + 2 * 4 + 2 * 4
        # chimera is bipartite (chi = 2) but greedy order may use one more;
        # correctness only needs a valid partition, tested globally in
        # test_model.TestColoring
        assert prob.num_colors <= 3

    def test_chimera_solvable(self):
        prob, _ = instances.chimera_graph(2, 2, t=2, rng=1)
        e_gs, _ = brute_force_ground(prob)
        res = solve(prob, method="sa", num_reads=16, sweeps=300, seed=0)
        assert np.isclose(res.best_energy, e_gs, atol=1e-3)


class TestCli:
    def test_solve_command(self, tmp_path, rng):
        import subprocess, sys, os, json

        prob, (r, c, v) = instances.random_2d_lattice(
            4, rng=np.random.default_rng(3)
        )
        inst = tmp_path / "inst.txt"
        instances.save_triplets(inst, r, c, v)
        # a fresh CPU-only process: the CLI as a user runs it
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
        out = subprocess.run(
            [sys.executable, "-m", "montecarlosolvers_tpu", "solve",
             str(inst), "--method", "sa", "--num-reads", "8",
             "--sweeps", "200", "--lattice", "4",
             "--out", str(tmp_path / "res.npz")],
            capture_output=True, text=True, env=env, timeout=240,
        )
        assert out.returncode == 0, out.stderr[-800:]
        payload = json.loads(out.stdout.strip().splitlines()[-1])
        e_gs, _ = brute_force_ground(prob)
        assert payload["best_energy"] <= e_gs + 0.15 * abs(e_gs)
        d = np.load(tmp_path / "res.npz")
        assert d["samples"].shape == (8, 16)

    def test_save_load_roundtrip(self, tmp_path):
        r = np.array([0, 1]); c = np.array([1, 2]); v = np.array([0.5, -1.25])
        p = tmp_path / "t.txt"
        instances.save_triplets(p, r, c, v)
        r2, c2, v2 = instances.load_triplets(p)
        assert np.array_equal(r, r2) and np.array_equal(c, c2)
        assert np.allclose(v, v2)


class TestClassicalClusterMethods:
    def test_sa_wolff_and_sa_sw_solve(self):
        from montecarlosolvers_tpu.models.instances import random_2d_lattice
        from montecarlosolvers_tpu.solvers.api import solve

        prob, _ = random_2d_lattice(4, rng=3)
        for method in ("sa_wolff", "sa_sw"):
            res = solve(prob, method=method, num_reads=8, sweeps=60, seed=0)
            assert len(res) == 8
            assert set(np.unique(res.samples)) <= {-1.0, 1.0}
            # energies sorted ascending, SA-comparable quality
            assert (np.diff(res.energies) >= 0).all()
        with pytest.raises(TypeError):
            solve(prob, method="sa_sw", num_reads=2, sweeps=10, slices=4)

    def test_sa_sw_beats_random_on_fm(self):
        """A pure-cluster anneal must reach the FM ground state."""
        from montecarlosolvers_tpu.bench.cluster_crossover import fm_lattice
        from montecarlosolvers_tpu.solvers.api import solve

        prob = fm_lattice(6)
        res = solve(prob, method="sa_sw", num_reads=4, sweeps=150, seed=1,
                    local_sweeps=False)
        # FM ground state energy: -2 * N (each of the 2N bonds at -1)
        assert res.energies[0] <= -2 * 36 + 1e-3


class TestPTAutoLadder:
    def test_auto_ladder_scales_with_n_and_exchanges(self, prob):
        res = solve(prob, method="pt", num_reads=4, sweeps=300, seed=3)
        # auto-sized ladder recorded and sqrt(N)-scaled: N=16 ->
        # ceil(ln(30) * 4 / 2.5) + 1 = 7
        assert res.info["ladder"] == 7
        assert res.info["mean_swap_rate"] > 0.1
        # explicit override still respected (no ladder key in info)
        res2 = solve(prob, method="pt", num_reads=4, sweeps=50, seed=3,
                     ladder=5)
        assert "ladder" not in res2.info

    def test_auto_ladder_swap_rate_in_band(self):
        """The 20-60% swap-rate band the rule targets, asserted at the
        CPU-sized points of the measured table (results/
        ladder_calibration: 0.37-0.46 across N=256..16384 lattice and
        N=256..2048 SK)."""
        import jax

        from montecarlosolvers_tpu.models import instances
        from montecarlosolvers_tpu.solvers import sa as sa_m, pt as pt_m
        from montecarlosolvers_tpu.solvers.api import _auto_ladder

        for build, n in (
            (lambda: instances.random_2d_lattice(16, rng=16, lattice=True)[0],
             256),
            (lambda: instances.sk_model(128, rng=128)[0], 128),
        ):
            problem = build()
            m = _auto_ladder(n, 0.5, 2.5)
            temps = pt_m.geometric_ladder(0.5, 2.5, m)
            s0 = sa_m.random_state(jax.random.key(n), n, batch=(m,))
            _, rate = pt_m.sample(problem, temps, s0, jax.random.key(n),
                                  200, swap_every=2)
            assert 0.2 <= float(rate) <= 0.6, (n, m, float(rate))


class TestICMMethod:
    def test_icm_reaches_ground_state_and_records_rates(self, prob):
        e_gs, _ = brute_force_ground(prob)
        res = solve(prob, method="icm", num_reads=5, sweeps=400, seed=2,
                    ladder=6, houdayer_every=2)
        assert len(res) == 5  # odd num_reads from ladder pairs
        assert res.best_energy <= e_gs + 1e-3
        assert res.info["mean_swap_rate"] > 0.05
        assert 0.0 < res.info["houdayer_flip_frac"] < 1.0


class TestPAMethod:
    def test_pa_reaches_ground_state_and_records_log_z(self, prob):
        e_gs, _ = brute_force_ground(prob)
        res = solve(prob, method="pa", num_reads=256, sweeps=150, seed=4,
                    beta_end=6.0, mcsteps=2)
        assert len(res) == 256
        assert res.best_energy <= e_gs + 1e-3
        # absolute free energy: at beta=6 on a small gapped instance,
        # ln Z ~ -beta*E_gs + ln(degeneracy); a generous sanity band
        assert res.info["log_z"] > -6.0 * e_gs - 5.0
        assert res.info["log_z"] < -6.0 * e_gs + prob.nspins
        assert 0.0 < res.info["min_ess_frac"] <= 1.0

    def test_pa_rejects_unknown_kw(self, prob):
        import pytest

        with pytest.raises(TypeError):
            solve(prob, method="pa", t_min=0.1)

    def test_pa_adaptive_reaches_ground_state(self, prob):
        e_gs, _ = brute_force_ground(prob)
        res = solve(prob, method="pa", num_reads=256, sweeps=400, seed=5,
                    beta_end=6.0, adaptive=True, mcsteps=2)
        assert res.best_energy <= e_gs + 1e-3
        assert res.info["reached"]
        assert 3 <= res.info["n_steps"] <= 400
        assert 1 <= res.info["families"] <= 256

    def test_paq_reaches_ground_state(self, prob):
        e_gs, _ = brute_force_ground(prob)
        res = solve(prob, method="paq", num_reads=64, sweeps=120, seed=6,
                    slices=6, field_start=2.5)
        assert len(res) == 64
        assert res.best_energy <= e_gs + 1e-3
        assert 0.0 < res.info["min_ess_frac"] <= 1.0


class TestCLI:
    def test_cli_methods_match_solve_table(self):
        """The --method choices must expose every solve() method (the
        CLI once listed only 6 of 11)."""
        from montecarlosolvers_tpu.__main__ import SOLVE_METHODS
        from montecarlosolvers_tpu.solvers.api import _METHOD_KW

        assert set(SOLVE_METHODS) == set(_METHOD_KW)

    def test_cli_solve_smoke(self, tmp_path, capsys):
        """End-to-end: triplet file -> solve -> JSON line + npz output."""
        import json

        from montecarlosolvers_tpu.__main__ import main

        # 4-spin ferromagnetic ring, 1-indexed triplets, gs energy -4
        inst = tmp_path / "ring.txt"
        inst.write_text(
            "1 2 -1\n2 3 -1\n3 4 -1\n4 1 -1\n"
        )
        out = tmp_path / "samples.npz"
        rc = main(["solve", str(inst), "--method", "sa", "--num-reads", "8",
                   "--sweeps", "50", "--out", str(out)])
        assert rc == 0
        line = [l for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")][-1]
        res = json.loads(line)
        assert res["best_energy"] == -4.0
        data = np.load(out)
        assert data["samples"].shape == (8, 4)
        assert data["energies"].min() == -4.0
