"""Utils tests: observables identities, checkpoint/resume bit-exactness,
profiling counters, and the MST harness's incremental checkpointing."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa
from montecarlosolvers_tpu.utils import observables as obs
from montecarlosolvers_tpu.utils.checkpoint import CheckpointedAnneal
from montecarlosolvers_tpu.utils.profiling import FlipCounter
from montecarlosolvers_tpu import schedules


class TestObservables:
    def test_magnetization_and_overlap(self, rng):
        s = jnp.asarray(rng.choice([-1.0, 1.0], size=(4, 10)))
        m = obs.magnetization(s)
        assert m.shape == (4,)
        assert np.allclose(np.asarray(m), np.asarray(s).mean(-1))
        q = obs.overlap(s[0], s[0])
        assert np.isclose(float(q), 1.0)
        Q = obs.replica_overlap_matrix(s)
        assert np.allclose(np.diag(np.asarray(Q)), 1.0)

    def test_residual_energy(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        s = jnp.ones(9)
        e = float(prob.energy(s))
        r = float(obs.residual_energy(prob, s, e - 9.0))
        assert np.isclose(r, 1.0)

    def test_acceptance_and_best(self, rng):
        a = jnp.asarray([[1.0, 1.0, -1.0]])
        b = jnp.asarray([[1.0, -1.0, -1.0]])
        assert np.isclose(float(obs.acceptance_fraction(a, b)[0]), 1 / 3)
        es = jnp.asarray([[3.0], [1.0], [2.0]])
        best = obs.best_energy_so_far(es)
        assert list(np.asarray(best[:, 0])) == [3.0, 1.0, 1.0]


class TestCheckpointedAnneal:
    def test_resume_is_bit_identical(self, rng, tmp_path):
        prob, _ = instances.random_2d_lattice(4, rng=rng)
        key = jax.random.key(0)
        s0 = sa.random_state(key, 16, batch=(3,))
        sched = schedules.linear(2.0, 0.1, 100)

        def solver(seg, state, seg_key):
            return sa.anneal(prob, seg, state, seg_key)

        # uninterrupted run
        ck1 = CheckpointedAnneal(str(tmp_path / "a.npz"), segment=30)
        full = ck1.run(solver, sched, s0, key)

        # interrupted run: stop after 2 segments, then resume
        ck2 = CheckpointedAnneal(str(tmp_path / "b.npz"), segment=30)
        state = s0
        for i in range(2):
            seg = np.asarray(sched)[i * 30:(i + 1) * 30]
            state = solver(jnp.asarray(seg), state, jax.random.fold_in(key, i))
            ck2._save(i + 1, state)
        resumed = ck2.run(solver, sched, s0, key)
        assert np.array_equal(np.asarray(full), np.asarray(resumed))

    def test_clear(self, tmp_path):
        ck = CheckpointedAnneal(str(tmp_path / "c.npz"))
        ck._save(1, np.zeros(3))
        assert os.path.exists(ck.path)
        ck.clear()
        assert not os.path.exists(ck.path)


class TestFlipCounter:
    def test_counts(self):
        fc = FlipCounter().start()
        fc.add_sweeps(10, 100, chains=4)
        fc.stop()
        assert fc.attempts == 4000
        assert fc.rate > 0


class TestMstHarness:
    def test_incremental_checkpointing(self, rng, tmp_path):
        from montecarlosolvers_tpu.bench import mst

        prob, _ = instances.random_2d_lattice(4, rng=rng, lattice=True)
        e_gs = float(prob.energy(jnp.ones(16)))  # arbitrary anchor
        res1, done1 = mst.mst_benchmark(
            prob, e_gs, outdir=str(tmp_path), taus=[20, 50], reps=3,
            exps=((1, 4),), verbose=False,
        )
        # second run must come entirely from cache, identical values
        res2, done2 = mst.mst_benchmark(
            prob, e_gs, outdir=str(tmp_path), taus=[20, 50], reps=3,
            exps=((1, 4),), verbose=False,
        )
        assert done1 and done2
        for k in res1:
            assert np.array_equal(res1[k]["eps"], res2[k]["eps"])
            assert np.array_equal(res1[k]["tau"], res2[k]["tau"])
        assert os.path.exists(tmp_path / "summary.json")

    def test_budget_resume(self, rng, tmp_path):
        """A zero-budget run stops before computing anything and reports
        incomplete; a later unbudgeted run finishes the matrix."""
        from montecarlosolvers_tpu.bench import mst

        prob, _ = instances.random_2d_lattice(4, rng=rng, lattice=True)
        e_gs = float(prob.energy(jnp.ones(16)))
        res, done = mst.mst_benchmark(
            prob, e_gs, outdir=str(tmp_path), taus=[20], reps=2,
            exps=((1, 4),), verbose=False, budget_s=0.0,
        )
        assert not done
        res, done = mst.mst_benchmark(
            prob, e_gs, outdir=str(tmp_path), taus=[20], reps=2,
            exps=((1, 4),), verbose=False,
        )
        assert done and "CA" in res and "PT=1_P=4" in res

    def test_plot(self, rng, tmp_path):
        from montecarlosolvers_tpu.bench import mst

        results = {"CA": (np.array([10, 100]), np.array([0.1, 0.01]))}
        mst.plot_results(results, path=str(tmp_path / "p.png"))
        assert os.path.exists(tmp_path / "p.png")
        # rich form, both x-axis conventions
        rich = {"PT=1_P=4": {"tau": np.array([10, 20]),
                             "total_sweeps": np.array([40, 80]),
                             "eps": np.array([0.05, 0.03])}}
        mst.plot_results(rich, path=str(tmp_path / "q.png"))
        mst.plot_results(rich, path=str(tmp_path / "r.png"), x="tau")
        assert os.path.exists(tmp_path / "r.png")


class TestValidateState:
    def test_accepts_valid(self):
        from montecarlosolvers_tpu.utils.checkpoint import validate_state

        validate_state(np.array([1.0, -1.0, 1.0]), "ising")
        validate_state(np.array([0.0, 1.5, np.pi]), "angles")

    def test_rejects_corruption(self):
        import pytest as _pytest
        from montecarlosolvers_tpu.utils.checkpoint import validate_state

        with _pytest.raises(FloatingPointError):
            validate_state(np.array([1.0, np.nan]), "ising")
        with _pytest.raises(ValueError):
            validate_state(np.array([1.0, 0.5]), "ising")
        with _pytest.raises(ValueError):
            validate_state(np.array([4.0]), "angles")

    def test_stale_chunk_cache_raises(self, rng, tmp_path):
        """A chunk file whose length doesn't match the current chunk size
        must fail loudly, not silently mis-assemble the energy array."""
        import pytest
        from montecarlosolvers_tpu.bench import mst

        prob, _ = instances.random_2d_lattice(4, rng=rng, lattice=True)
        prefix = str(tmp_path / "pt_tau20")
        np.savez(f"{prefix}.chunk0.npz", energies=np.zeros(3))  # stale: 3
        with pytest.raises(ValueError, match="different chunk size"):
            mst.piqmc_arm(prob, 20, 4, jax.random.key(0), slices=4,
                          chunk=4, cache_prefix=prefix)


class TestPersistentCache:
    """enable_persistent_cache: JAX_COMPILATION_CACHE_DIR wins untouched;
    otherwise the checkout's fixed .xla_cache."""

    def _recording(self, monkeypatch):
        import jax

        calls = {}
        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: calls.__setitem__(k, v))
        return calls

    def test_env_dir_is_left_to_jax(self, monkeypatch, tmp_path):
        from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        calls = self._recording(monkeypatch)
        assert enable_persistent_cache() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in calls

    def test_default_is_checkout_dir(self, monkeypatch):
        from montecarlosolvers_tpu.utils import xla_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        calls = self._recording(monkeypatch)
        path = xla_cache.enable_persistent_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".xla_cache") == xla_cache.CHECKOUT_CACHE_DIR
        assert calls["jax_compilation_cache_dir"] == path
        assert os.path.isdir(path)

    def test_path_is_stable_across_calls(self, monkeypatch):
        from montecarlosolvers_tpu.utils.xla_cache import enable_persistent_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        self._recording(monkeypatch)
        assert enable_persistent_cache() == enable_persistent_cache()


class TestDevice:
    def test_require_gpu_names_the_platform(self):
        from montecarlosolvers_tpu.utils import device

        with pytest.raises(device.NoGPUError, match="platform 'cpu'"):
            device.require_gpu()
        assert device.describe()["platform"] == "cpu"

    def test_card_without_nvidia_smi(self, monkeypatch):
        from montecarlosolvers_tpu.utils import device

        monkeypatch.setenv("PATH", "")
        assert device.card().startswith("unavailable")


class TestFlipCounterBarrier:
    def test_stop_waits_for_result(self):
        import jax.numpy as jnp

        fc = FlipCounter().start()
        fc.add_sweeps(1, 16)
        out = jnp.ones(16) * 2
        fc.stop(out)
        assert fc.elapsed > 0 and fc.rate > 0
