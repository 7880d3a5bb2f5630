"""Dense (matmul) engine: exact sequential-Metropolis semantics via matmul
fields + rank-1 delayed updates. Gibbs exactness, oracle equivalence,
brute-forced ground states, block-boundary handling."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlosolvers_tpu.models.dense import DenseProblem
from montecarlosolvers_tpu.models.ising import IsingProblem
from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.ops.dense_sweep import dense_metropolis_sweep, dense_anneal
from montecarlosolvers_tpu.solvers import sa
from montecarlosolvers_tpu import schedules


def _dense_sk(n, rng):
    J = rng.normal(size=(n, n)) / np.sqrt(n)
    return DenseProblem.from_couplings(J)


class TestProblem:
    def test_energy_matches_generic(self, rng):
        n = 10
        Jraw = rng.normal(size=(n, n))
        dp = DenseProblem.from_couplings(Jraw)
        # equivalent generic problem: symmetrized pairs + diagonal fields
        Js = Jraw + Jraw.T
        rows, cols, vals = [], [], []
        for i in range(n):
            rows.append(i); cols.append(i); vals.append(Jraw[i, i])
            for j in range(i + 1, n):
                rows.append(i); cols.append(j); vals.append(Js[i, j])
        gen = IsingProblem.from_edges(n, rows, cols, vals, maxnb=n)
        for _ in range(5):
            s = jnp.asarray(rng.choice([-1.0, 1.0], size=n), jnp.float32)
            assert np.isclose(float(dp.energy(s)), float(gen.energy(s)),
                              rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                np.asarray(dp.local_fields(s)),
                np.asarray(gen.local_fields(s)), rtol=1e-4, atol=1e-4,
            )

    def test_delta_e_matches_flip(self, rng):
        dp = _dense_sk(8, rng)
        s = jnp.asarray(rng.choice([-1.0, 1.0], size=8), jnp.float32)
        de = np.asarray(dp.delta_e(s))
        for i in range(8):
            s2 = s.at[i].multiply(-1.0)
            exact = float(dp.energy(s2) - dp.energy(s))
            assert np.isclose(de[i], exact, rtol=1e-4, atol=1e-4)


class TestSweep:
    def test_gibbs_distribution(self, rng):
        """Systematic-scan blocked sweep must sample the exact Boltzmann
        distribution (3 fully-coupled spins + fields, 8 states)."""
        J = np.array([
            [0.3, 1.0, 0.5],
            [0.0, -0.2, -0.7],
            [0.0, 0.0, 0.4],
        ])
        dp = DenseProblem.from_couplings(J)
        temp = 1.5
        states = (((np.arange(8)[:, None] >> np.arange(3)) & 1) * 2 - 1).astype(
            np.float32
        )
        es = np.asarray(dp.energy(jnp.asarray(states)))
        w = np.exp(-es / temp)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 1500, 100
        key = jax.random.key(0)
        s0 = sa.random_state(key, 3, batch=(chains,))

        @jax.jit
        def run(s, key):
            keys = jax.random.split(key, nsweeps)

            def body(s, k):
                s = dense_metropolis_sweep(dp, s, k, temp, block=2)
                bits = (s > 0).astype(jnp.int32)
                idx = bits[:, 0] + 2 * bits[:, 1] + 4 * bits[:, 2]
                return s, idx

            _, idxs = jax.lax.scan(body, s, keys)
            return idxs

        idxs = np.asarray(run(s0, key))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=8)
        p_emp = counts / counts.sum()
        assert np.max(np.abs(p_emp - p_exact)) < 0.01, (p_emp, p_exact)

    def test_block_boundaries(self, rng):
        """N not divisible by block: padded spins must stay inert."""
        dp = _dense_sk(10, rng)
        key = jax.random.key(1)
        s0 = sa.random_state(key, 10, batch=(4,))
        for block in (3, 4, 10, 128):
            out = dense_metropolis_sweep(dp, s0, key, 1.0, block=block)
            assert out.shape == (4, 10)
            assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}

    def test_deterministic(self, rng):
        dp = _dense_sk(12, rng)
        key = jax.random.key(2)
        s0 = sa.random_state(key, 12, batch=(3,))
        sched = schedules.linear(2.0, 0.1, 30)
        a = dense_anneal(dp, sched, s0, key)
        b = dense_anneal(dp, sched, s0, key)
        assert np.array_equal(np.asarray(a), np.asarray(b))


class TestShuffledScan:
    def test_gibbs_distribution_shuffled(self, rng):
        """Random-scan (shuffled) sweep must also sample the exact
        Boltzmann distribution."""
        J = np.array([
            [0.3, 1.0, 0.5],
            [0.0, -0.2, -0.7],
            [0.0, 0.0, 0.4],
        ])
        dp = DenseProblem.from_couplings(J)
        temp = 1.5
        states = (((np.arange(8)[:, None] >> np.arange(3)) & 1) * 2 - 1
                  ).astype(np.float32)
        es = np.asarray(dp.energy(jnp.asarray(states)))
        w = np.exp(-es / temp)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 1500, 100
        key = jax.random.key(3)
        s0 = sa.random_state(key, 3, batch=(chains,))

        @jax.jit
        def run(s, key):
            keys = jax.random.split(key, nsweeps)

            def body(s, k):
                s = dense_metropolis_sweep(dp, s, k, temp, block=2,
                                           shuffle=True)
                bits = (s > 0).astype(jnp.int32)
                idx = bits[:, 0] + 2 * bits[:, 1] + 4 * bits[:, 2]
                return s, idx

            _, idxs = jax.lax.scan(body, s, keys)
            return idxs

        idxs = np.asarray(run(s0, key))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=8)
        p_emp = counts / counts.sum()
        assert np.max(np.abs(p_emp - p_exact)) < 0.01, (p_emp, p_exact)

    def test_shuffle_changes_order_not_set(self, rng):
        """At T=0 from a fixed start, shuffled and systematic scans reach
        (possibly different) local minima; both stay +/-1-valued, and the
        shuffled result is deterministic in the key."""
        dp = _dense_sk(10, rng)
        key = jax.random.key(4)
        s0 = sa.random_state(key, 10, batch=(4,))
        a = dense_metropolis_sweep(dp, s0, key, 0.5, block=4, shuffle=True)
        b = dense_metropolis_sweep(dp, s0, key, 0.5, block=4, shuffle=True)
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert set(np.unique(np.asarray(a))) <= {-1.0, 1.0}
        assert a.shape == s0.shape

    def test_shuffle_block_boundaries(self, rng):
        dp = _dense_sk(10, rng)
        key = jax.random.key(5)
        s0 = sa.random_state(key, 10, batch=(4,))
        for block in (3, 10, 128):
            out = dense_metropolis_sweep(dp, s0, key, 1.0, block=block,
                                         shuffle=True)
            assert out.shape == (4, 10)
            assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}


class TestBf16Matmul:
    def test_pm1_couplings_bitwise_f32(self, rng):
        """+/-1-valued couplings are exact in bfloat16, so bf16-matmul
        trajectories must be bitwise identical to float32."""
        n = 24
        J = np.triu(rng.choice([-1.0, 1.0], size=(n, n)), k=1)
        dp = DenseProblem.from_couplings(J)
        key = jax.random.key(6)
        s0 = sa.random_state(key, n, batch=(8,))
        sched = schedules.linear(3.0, 0.2, 60)
        a = dense_anneal(dp, sched, s0, key, block=8)
        b = dense_anneal(dp, sched, s0, key, block=8,
                         matmul_dtype=jnp.bfloat16)
        assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_gibbs_on_rounded_problem(self, rng):
        """bf16 matmuls sample the EXACT Gibbs distribution of the
        bf16-rounded problem (not an approximation of the f32 one)."""
        J = np.array([
            [0.3, 1.0, 0.5],
            [0.0, -0.2, -0.7],
            [0.0, 0.0, 0.4],
        ])
        dp = DenseProblem.from_couplings(J)
        # reference probabilities come from the rounded couplings (h is
        # added in f32 and unrounded)
        Jr = np.asarray(dp.J.astype(jnp.bfloat16).astype(jnp.float32))
        dpr = DenseProblem(J=jnp.asarray(Jr), h=dp.h, nspins=3)
        temp = 1.5
        states = (((np.arange(8)[:, None] >> np.arange(3)) & 1) * 2 - 1
                  ).astype(np.float32)
        es = np.asarray(dpr.energy(jnp.asarray(states)))
        w = np.exp(-es / temp)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 1500, 100
        key = jax.random.key(7)
        s0 = sa.random_state(key, 3, batch=(chains,))

        @jax.jit
        def run(s, key):
            keys = jax.random.split(key, nsweeps)

            def body(s, k):
                s = dense_metropolis_sweep(dp, s, k, temp, block=2,
                                           matmul_dtype=jnp.bfloat16)
                bits = (s > 0).astype(jnp.int32)
                idx = bits[:, 0] + 2 * bits[:, 1] + 4 * bits[:, 2]
                return s, idx

            _, idxs = jax.lax.scan(body, s, keys)
            return idxs

        idxs = np.asarray(run(s0, key))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=8)
        p_emp = counts / counts.sum()
        assert np.max(np.abs(p_emp - p_exact)) < 0.01, (p_emp, p_exact)

    def test_bf16_shuffled_combo(self, rng):
        dp = _dense_sk(9, rng)
        key = jax.random.key(8)
        s0 = sa.random_state(key, 9, batch=(4,))
        out = dense_anneal(dp, schedules.linear(2.0, 0.1, 30), s0, key,
                           block=4, shuffle=True,
                           matmul_dtype=jnp.bfloat16)
        assert out.shape == (4, 9)
        assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}


class TestAnneal:
    def test_finds_ground_state(self, rng):
        dp = _dense_sk(12, rng)
        states = (((np.arange(2 ** 12)[:, None] >> np.arange(12)) & 1) * 2 - 1
                  ).astype(np.float32)
        e_gs = float(np.asarray(dp.energy(jnp.asarray(states))).min())
        key = jax.random.key(0)
        s0 = sa.random_state(key, 12, batch=(16,))
        out = sa.anneal(dp, schedules.linear(2.0, 0.0, 300), s0, key)
        es = np.asarray(dp.energy(out))
        assert np.isclose(es.min(), e_gs, atol=1e-3), (es.min(), e_gs)

    def test_solve_api_with_dense(self, rng):
        from montecarlosolvers_tpu.solvers.api import solve

        dp = _dense_sk(10, rng)
        res = solve(dp, method="sa", num_reads=8, sweeps=150, seed=0)
        assert len(res) == 8
        assert set(np.unique(res.samples)) <= {-1.0, 1.0}


class TestDensePT:
    def test_pt_marginals_match_gibbs(self, rng):
        """Parallel tempering over a dense problem: per-rung mean energies
        must match exact Gibbs averages."""
        from montecarlosolvers_tpu.solvers import pt

        J = np.array([
            [0.0, 0.9, -0.4],
            [0.0, 0.0, 0.6],
            [0.0, 0.0, 0.0],
        ])
        dp = DenseProblem.from_couplings(J + np.diag([0.3, -0.2, 0.1]))
        temps = jnp.asarray([0.8, 1.6, 3.2])
        states_all = (((np.arange(8)[:, None] >> np.arange(3)) & 1) * 2 - 1
                      ).astype(np.float32)
        es_all = np.asarray(dp.energy(jnp.asarray(states_all)))

        key = jax.random.key(0)
        s0 = sa.random_state(key, 3, batch=(3,))
        out, rate, es = pt.sample(dp, temps, s0, key, 20000, swap_every=2,
                                  collect_energy=True)
        es = np.asarray(es)[2000:]
        assert float(rate) > 0.05
        for k, t in enumerate(np.asarray(temps)):
            w = np.exp(-es_all / t)
            exact = float((w * es_all).sum() / w.sum())
            assert abs(es[:, k].mean() - exact) < 0.05, (k, t)


class TestReviewFixes:
    def test_multi_leading_dims(self, rng):
        """sa.anneal on a DenseProblem must accept (..., N) batches like
        the sparse path."""
        dp = _dense_sk(8, rng)
        key = jax.random.key(0)
        s0 = sa.random_state(key, 8, batch=(2, 3))
        out = sa.anneal(dp, schedules.linear(2.0, 0.1, 20), s0, key)
        assert out.shape == (2, 3, 8)
        out2, es = sa.anneal(dp, schedules.linear(2.0, 0.1, 20), s0, key,
                             collect_energy=True)
        assert es.shape == (20, 2, 3)

    def test_symmetric_input_not_doubled(self, rng):
        """from_couplings must not double already-symmetric matrices."""
        J = np.array([[0.0, 1.0], [1.0, 0.0]])
        dp = DenseProblem.from_couplings(J)
        s = jnp.asarray([1.0, 1.0])
        assert np.isclose(float(dp.energy(s)), 1.0)
        # round-trip through the internal convention is idempotent
        dp2 = DenseProblem.from_couplings(np.asarray(dp.J))
        assert np.isclose(float(dp2.energy(s)), float(dp.energy(s)))
        # upper-triangular storage still counts each entry once
        dp3 = DenseProblem.from_couplings(np.triu(J))
        assert np.isclose(float(dp3.energy(s)), 1.0)

    def test_solve_rejects_unknown_kw(self, rng):
        from montecarlosolvers_tpu.solvers.api import solve

        dp = _dense_sk(6, rng)
        with pytest.raises(TypeError):
            solve(dp, method="sa", num_reads=2, sweeps=10, t_stop=0.5)
