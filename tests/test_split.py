"""Split-checkerboard engine tests (ops/split.py): exact field equality
against the plane-roll LatticeProblem path, pack/unpack roundtrips, energy
identities, Gibbs correctness of the maskless phases, and solver-dispatch
consistency."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.models.lattice import LatticeProblem
from montecarlosolvers_tpu.ops import split as sp
from montecarlosolvers_tpu.solvers import sa, qmc
from montecarlosolvers_tpu import schedules
from tests.test_sa import brute_force_ground


def _lat(L, rng, with_fields=False):
    lat, _ = instances.random_2d_lattice(
        L, rng=rng, with_fields=with_fields, lattice=True
    )
    return lat


def _periodic_lat(L, rng, with_fields=False):
    """Fully periodic random-Gaussian lattice (all wrap couplings nonzero)
    — the benchmark instance's boundary type (santoro_80x80.txt has 2*L*L
    edges, i.e. periodic; examples/santoro80.py:242-244)."""
    rng = np.random.default_rng(rng)
    h = rng.normal(size=(L, L)) * 0.1 if with_fields else None
    return LatticeProblem.from_planes(
        rng.normal(size=(L, L)), rng.normal(size=(L, L)), h
    )


class TestLayout:
    def test_supports_split(self, rng):
        assert sp.supports_split(_lat(4, rng))
        assert not sp.supports_split(_lat(5, rng))  # odd L
        assert sp.supports_split(_lat(4, rng), slices=8)
        assert not sp.supports_split(_lat(4, rng), slices=5)  # odd P
        prob, _ = instances.random_2d_lattice(4, rng=rng)  # generic IsingProblem
        assert not sp.supports_split(prob)
        # periodic lattice: supported via the row-wrap correction slots
        per = LatticeProblem.from_planes(np.ones((4, 4)), np.ones((4, 4)))
        assert per.col_wrap
        assert sp.supports_split(per)
        assert not _lat(4, rng).col_wrap  # open lattice needs no wrap slots

    def test_pack_unpack_classical_roundtrip(self, rng):
        lat = _lat(6, rng)
        sl = sp.build_split(lat)
        s = sa.random_state(jax.random.key(0), lat.nspins, batch=(3,))
        a, b = sp.pack_classical(sl, s)
        assert a.shape == (3, lat.nspins // 2)
        out = sp.unpack_classical(sl, a, b)
        assert np.array_equal(np.asarray(out), np.asarray(s))

    def test_pack_unpack_qmc_roundtrip(self, rng):
        lat = _lat(4, rng)
        sl = sp.build_split(lat)
        confs = qmc.replicate(
            sa.random_state(jax.random.key(1), lat.nspins, batch=(2,)), 6
        )
        # decorrelate the slices so ordering bugs can't hide
        confs = confs * jnp.where(
            jax.random.bernoulli(jax.random.key(2), 0.5, confs.shape), 1.0, -1.0
        )
        xe, xo, ye, yo = sp.pack_qmc(sl, confs)
        assert xe.shape == (2, 3, lat.nspins // 2)
        out = sp.unpack_qmc(sl, xe, xo, ye, yo)
        assert np.array_equal(np.asarray(out), np.asarray(confs))

    @pytest.mark.parametrize("periodic", [False, True])
    def test_spatial_field_matches_lattice_fields(self, rng, periodic):
        """The offset-weighted roll stencil must reproduce local_fields
        exactly at each color's sites (both colors, fields included, open
        and periodic boundaries)."""
        lat = (
            _periodic_lat(6, 17, with_fields=True)
            if periodic
            else _lat(6, rng, with_fields=True)
        )
        sl = sp.build_split(lat)
        s = sa.random_state(jax.random.key(3), lat.nspins, batch=(2,))
        a, b = sp.pack_classical(sl, s)
        ref = np.asarray(lat.local_fields(s))
        fa = sp._spatial_field(sl.w_ab[:, 0], b, sl.K) + sl.h_ab[0]
        fb = sp._spatial_field(sl.w_ab[:, 1], a, sl.K) + sl.h_ab[1]
        assert np.allclose(np.asarray(fa), ref[:, list(sl.idx_a)], atol=1e-5)
        assert np.allclose(np.asarray(fb), ref[:, list(sl.idx_b)], atol=1e-5)

    @pytest.mark.parametrize("periodic", [False, True])
    def test_classical_energy_matches(self, rng, periodic):
        lat = (
            _periodic_lat(6, 23, with_fields=True)
            if periodic
            else _lat(6, rng, with_fields=True)
        )
        sl = sp.build_split(lat)
        s = sa.random_state(jax.random.key(4), lat.nspins, batch=(4,))
        a, b = sp.pack_classical(sl, s)
        e = sp.classical_energy_split(sl, a, b)
        assert np.allclose(np.asarray(e), np.asarray(lat.energy(s)), atol=1e-4)

    def test_spatial_field_matches_on_santoro_instance(self):
        """Wrap-slot exactness on the real (periodic) benchmark lattice."""
        try:
            lat, _ = instances.santoro_80x80(lattice=True)
        except FileNotFoundError:
            pytest.skip("benchmark instance data unavailable")
        assert lat.col_wrap and sp.supports_split(lat, 40)
        sl = sp.build_split(lat)
        s = sa.random_state(jax.random.key(9), lat.nspins)
        a, b = sp.pack_classical(sl, s)
        ref = np.asarray(lat.local_fields(s))
        fa = sp._spatial_field(sl.w_ab[:, 0], b, sl.K) + sl.h_ab[0]
        fb = sp._spatial_field(sl.w_ab[:, 1], a, sl.K) + sl.h_ab[1]
        assert np.allclose(np.asarray(fa), ref[list(sl.idx_a)], atol=1e-4)
        assert np.allclose(np.asarray(fb), ref[list(sl.idx_b)], atol=1e-4)

    def test_qmc_slice_energies_match(self, rng):
        lat = _lat(4, rng)
        sl = sp.build_split(lat)
        confs = qmc.replicate(
            sa.random_state(jax.random.key(5), lat.nspins, batch=(2,)), 4
        )
        confs = confs * jnp.where(
            jax.random.bernoulli(jax.random.key(6), 0.5, confs.shape), 1.0, -1.0
        )
        state = sp.pack_qmc(sl, confs)
        es = sp.qmc_slice_energies_split(sl, *state)
        assert np.allclose(np.asarray(es), np.asarray(lat.energy(confs)), atol=1e-4)


class TestSweepPhysics:
    def test_sa_sweep_energy_nonincreasing_at_zero_temp(self, rng):
        lat = _lat(6, rng)
        sl = sp.build_split(lat)
        s = sa.random_state(jax.random.key(0), lat.nspins)
        a, b = sp.pack_classical(sl, s)
        key = jax.random.key(1)
        e_prev = float(sp.classical_energy_split(sl, a, b))
        for _ in range(5):
            key, k = jax.random.split(key)
            a, b = sp.sa_split_sweep(sl, a, b, k, 1e-9)
            e = float(sp.classical_energy_split(sl, a, b))
            assert e <= e_prev + 1e-4
            e_prev = e

    def test_qmc_extended_energy_nonincreasing_at_zero_temp(self, rng):
        from tests.test_qmc import extended_energy

        lat = _lat(4, rng)
        sl = sp.build_split(lat)
        confs = qmc.replicate(sa.random_state(jax.random.key(2), lat.nspins), 6)
        confs = confs.at[2, :5].multiply(-1.0)
        temp, gamma = 1e-6, 1.0
        state = sp.pack_qmc(sl, confs)
        key = jax.random.key(3)
        e_prev = float(extended_energy(lat, sp.unpack_qmc(sl, *state), temp, gamma))
        for _ in range(4):
            key, k = jax.random.split(key)
            state = sp.qmc_split_sweep(sl, *state, k, temp, gamma, 1.0)
            e = float(extended_energy(lat, sp.unpack_qmc(sl, *state), temp, gamma))
            assert e <= e_prev + 1e-3
            e_prev = e

    def test_global_moves_energy_nonincreasing_at_zero_temp(self, rng):
        lat = _lat(4, rng)
        sl = sp.build_split(lat)
        confs = qmc.replicate(sa.random_state(jax.random.key(4), lat.nspins), 4)
        state = sp.pack_qmc(sl, confs)
        key = jax.random.key(5)
        e_prev = float(jnp.sum(sp.qmc_slice_energies_split(sl, *state)))
        for _ in range(3):
            key, k = jax.random.split(key)
            state = sp.qmc_split_global(sl, *state, k, 1e-6, 1.0)
            e = float(jnp.sum(sp.qmc_slice_energies_split(sl, *state)))
            assert e <= e_prev + 1e-3
            e_prev = e

    @pytest.mark.parametrize("periodic", [False, True])
    def test_sa_sweep_samples_gibbs(self, rng, periodic):
        """Maskless half-phase sweep must sample the exact Boltzmann
        distribution of a 2x2 lattice (16 states), open and periodic (the
        periodic case drives the row-wrap correction slots)."""
        lat = (
            _periodic_lat(2, 7) if periodic else _lat(2, np.random.default_rng(7))
        )
        sl = sp.build_split(lat)
        temp = 1.2

        states = []
        for bits in range(16):
            states.append(
                np.array([(bits >> i) & 1 for i in range(4)]) * 2.0 - 1.0
            )
        states = jnp.asarray(np.stack(states, dtype=np.float32))
        es = np.asarray(lat.energy(states))
        w = np.exp(-es / temp)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 1500, 200
        s0 = sa.random_state(jax.random.key(0), 4, batch=(chains,))
        a, b = sp.pack_classical(sl, s0)
        weights = jnp.asarray([1, 2, 4, 8])

        @jax.jit
        def run(a, b, key):
            keys = jax.random.split(key, nsweeps)

            def body(carry, k):
                a, b = carry
                a, b = sp.sa_split_sweep(sl, a, b, k, temp)
                s = sp.unpack_classical(sl, a, b)
                idx = ((s > 0).astype(jnp.int32) @ weights)
                return (a, b), idx

            _, idxs = jax.lax.scan(body, (a, b), keys)
            return idxs

        idxs = np.asarray(run(a, b, jax.random.key(1)))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=16)
        p_emp = counts / counts.sum()
        assert np.max(np.abs(p_emp - p_exact)) < 0.01, (p_emp, p_exact)

    def test_qmc_sweep_samples_extended_gibbs(self, rng):
        """Split PIQMC phases must sample the extended-Hamiltonian Gibbs
        measure on a 2x2 lattice with P=2 (256 states; TV-distance check)."""
        from tests.test_qmc import extended_energy

        lat = _lat(2, np.random.default_rng(11))
        sl = sp.build_split(lat)
        slices, temp, gamma, b = 2, 0.9, 0.7, 1.0
        teff = temp * slices

        states = []
        for bits in range(256):
            s = np.array([(bits >> i) & 1 for i in range(8)]) * 2.0 - 1.0
            states.append(s.reshape(2, 4).astype(np.float32))
        states = jnp.asarray(np.stack(states))
        es = np.asarray(extended_energy(lat, states, temp, gamma, b=b))
        w = np.exp(-es / teff)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 4000, 400
        confs0 = jnp.where(
            jax.random.bernoulli(jax.random.key(0), 0.5, (chains, 2, 4)),
            1.0, -1.0,
        )
        state0 = sp.pack_qmc(sl, confs0)
        weights = jnp.asarray([1 << i for i in range(8)])

        @jax.jit
        def run(state, key):
            keys = jax.random.split(key, nsweeps)

            def body(state, k):
                state = sp.qmc_split_sweep(sl, *state, k, temp, gamma, b)
                s = sp.unpack_qmc(sl, *state)
                bits = (s > 0).astype(jnp.int32).reshape(s.shape[0], 8)
                return state, bits @ weights

            _, idxs = jax.lax.scan(body, state, keys)
            return idxs

        idxs = np.asarray(run(state0, jax.random.key(1)))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=256)
        p_emp = counts / counts.sum()
        tv = 0.5 * np.abs(p_emp - p_exact).sum()
        assert tv < 0.02, tv


class TestBathSplit:
    def test_bath_sweep_samples_extended_gibbs(self):
        """The split dissipative sweep must sample the exact Boltzmann
        distribution of the bath-extended Hamiltonian (2x2 lattice, P=2,
        256 states; same harness as the non-bath split test above and the
        masked-engine test in test_qmc.py)."""
        from tests.test_qmc import extended_energy
        from montecarlosolvers_tpu.ops import piqmc as piqmc_ops

        lat = _lat(2, np.random.default_rng(11))
        sl = sp.build_split(lat)
        slices, temp, gamma, bs = 2, 0.9, 0.7, 1.0
        teff = temp * slices
        lut = schedules.bath_lookuptable(slices, 0.05)
        bath_mat = piqmc_ops.bath_matrix(lut, slices)

        states = []
        for bits in range(256):
            s = np.array([(bits >> i) & 1 for i in range(8)]) * 2.0 - 1.0
            states.append(s.reshape(2, 4).astype(np.float32))
        states = jnp.asarray(np.stack(states))
        es = np.asarray(
            extended_energy(lat, states, temp, gamma, b=bs, lookuptable=lut)
        )
        w = np.exp(-es / teff)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 4000, 400
        confs0 = jnp.where(
            jax.random.bernoulli(jax.random.key(0), 0.5, (chains, 2, 4)),
            1.0, -1.0,
        )
        a0, b0 = sp.pack_classical(sl, confs0)
        weights = jnp.asarray([1 << i for i in range(8)])

        @jax.jit
        def run(a0, b0, key):
            keys = jax.random.split(key, nsweeps)

            def body(carry, k):
                a, b = sp.qmc_bath_split_sweep(
                    sl, *carry, k, temp, gamma, bs, bath_mat
                )
                s = sp.unpack_classical(sl, a, b)
                bits = (s > 0).astype(jnp.int32).reshape(s.shape[0], 8)
                return (a, b), bits @ weights

            _, idxs = jax.lax.scan(body, (a0, b0), keys)
            return idxs

        idxs = np.asarray(run(a0, b0, jax.random.key(1)))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=256)
        p_emp = counts / counts.sum()
        tv = 0.5 * np.abs(p_emp - p_exact).sum()
        assert tv < 0.02, tv

    def test_colored_bath_sweep_near_extended_gibbs(self):
        """The snapshot-bath colored sweep (quarter layout) is approximate
        by design; on the exactly enumerable 2x2/P=2 system at the
        benchmark-scale coupling its stationary distribution must sit at
        the sampling-noise floor from the exact extended Gibbs measure
        (measured TV ~0.010; exact samplers score ~0.01-0.02 in the same
        harness)."""
        from tests.test_qmc import extended_energy
        from montecarlosolvers_tpu.ops import piqmc as piqmc_ops

        lat = _lat(2, np.random.default_rng(11))
        sl = sp.build_split(lat)
        slices, temp, gamma, bs = 2, 0.9, 0.7, 1.0
        teff = temp * slices
        lut = schedules.bath_lookuptable(slices, 0.05)
        bath_mat = piqmc_ops.bath_matrix(lut, slices)

        states = []
        for bits in range(256):
            s = np.array([(bits >> i) & 1 for i in range(8)]) * 2.0 - 1.0
            states.append(s.reshape(2, 4).astype(np.float32))
        states = jnp.asarray(np.stack(states))
        es = np.asarray(
            extended_energy(lat, states, temp, gamma, b=bs, lookuptable=lut)
        )
        w = np.exp(-es / teff)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 4000, 400
        confs0 = jnp.where(
            jax.random.bernoulli(jax.random.key(0), 0.5, (chains, 2, 4)),
            1.0, -1.0,
        )
        state0 = sp.pack_qmc(sl, confs0)
        weights = jnp.asarray([1 << i for i in range(8)])

        @jax.jit
        def run(state, key):
            keys = jax.random.split(key, nsweeps)

            def body(state, k):
                state = sp.qmc_bath_split_colored_sweep(
                    sl, *state, k, temp, gamma, bs, bath_mat
                )
                s = sp.unpack_qmc(sl, *state)
                bits = (s > 0).astype(jnp.int32).reshape(s.shape[0], 8)
                return state, bits @ weights

            _, idxs = jax.lax.scan(body, state, keys)
            return idxs

        idxs = np.asarray(run(state0, jax.random.key(1)))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=256)
        p_emp = counts / counts.sum()
        tv = 0.5 * np.abs(p_emp - p_exact).sum()
        assert tv < 0.03, tv

    def test_colored_bath_masked_form_near_extended_gibbs(self):
        """Same bar for the generic masked form
        (piqmc.dissipative_colored_sweep), which arbitrary graphs and odd
        P dispatch to."""
        from tests.test_qmc import extended_energy
        from montecarlosolvers_tpu.ops import piqmc as piqmc_ops

        prob, _ = instances.random_2d_lattice(2, rng=11)
        slices, temp, gamma, bs = 2, 0.9, 0.7, 1.0
        teff = temp * slices
        lut = schedules.bath_lookuptable(slices, 0.05)
        bath_mat = piqmc_ops.bath_matrix(lut, slices)

        states = []
        for bits in range(256):
            s = np.array([(bits >> i) & 1 for i in range(8)]) * 2.0 - 1.0
            states.append(s.reshape(2, 4).astype(np.float32))
        states = jnp.asarray(np.stack(states))
        es = np.asarray(
            extended_energy(prob, states, temp, gamma, b=bs, lookuptable=lut)
        )
        w = np.exp(-es / teff)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 64, 4000, 400
        confs0 = jnp.where(
            jax.random.bernoulli(jax.random.key(0), 0.5, (chains, 2, 4)),
            1.0, -1.0,
        )
        weights = jnp.asarray([1 << i for i in range(8)])

        @jax.jit
        def run(confs, key):
            keys = jax.random.split(key, nsweeps)

            def body(c, k):
                c = piqmc_ops.dissipative_colored_sweep(
                    prob, c, k, temp, gamma, bs, bath_mat
                )
                bits = (c > 0).astype(jnp.int32).reshape(c.shape[0], 8)
                return c, bits @ weights

            _, idxs = jax.lax.scan(body, confs, keys)
            return idxs

        idxs = np.asarray(run(confs0, jax.random.key(1)))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=256)
        p_emp = counts / counts.sum()
        tv = 0.5 * np.abs(p_emp - p_exact).sum()
        assert tv < 0.03, tv

    def test_bath_update_colored_dispatch_and_validation(self, rng):
        lat = _lat(4, rng)
        lut = schedules.bath_lookuptable(4, 1e-2)
        key = jax.random.key(6)
        confs = qmc.replicate(sa.random_state(key, lat.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 12)
        out = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                         lookuptable=lut, bath_update="colored",
                         global_moves=True)
        assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}
        out2 = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                          lookuptable=lut, bath_update="colored",
                          global_moves=True)
        assert np.array_equal(np.asarray(out), np.asarray(out2))
        # odd P falls back to the masked colored form
        confs5 = qmc.replicate(sa.random_state(key, lat.nspins), 5)
        lut5 = schedules.bath_lookuptable(5, 1e-2)
        out5 = qmc.anneal(lat, a, jnp.ones_like(a), 0.2, confs5, key,
                          lookuptable=lut5, bath_update="colored")
        assert set(np.unique(np.asarray(out5))) <= {-1.0, 1.0}
        with pytest.raises(ValueError, match="bath_update"):
            qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                       lookuptable=lut, bath_update="snapshot")

    def test_solver_dispatch_matches_masked_engine_statistically(self, rng):
        """qmc.anneal(lookuptable=...) on an even-L lattice with even P now
        routes through the split bath engine; its annealed energies must
        agree with the generic masked engine (same problem as a generic
        IsingProblem) within chain-statistics tolerance."""
        L, slices = 4, 4
        lat = _lat(L, np.random.default_rng(7))
        gen = lat.to_generic()
        lut = schedules.bath_lookuptable(slices, 1e-2)
        key = jax.random.key(3)
        confs = qmc.replicate(
            sa.random_state(key, lat.nspins, batch=(48,)), slices
        )
        a = schedules.transverse_field(2.5, 1e-8, 150)
        out_s = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                           lookuptable=lut, global_moves=True)
        out_m = qmc.anneal(gen, a, jnp.ones_like(a), 0.25, confs, key,
                           lookuptable=lut, global_moves=True)
        es = np.asarray(qmc.best_slice_energy(lat, out_s)).mean()
        em = np.asarray(qmc.best_slice_energy(gen, out_m)).mean()
        assert set(np.unique(np.asarray(out_s))) <= {-1.0, 1.0}
        assert np.isclose(es, em, atol=1.5), (es, em)

    def test_bath_collect_energy_and_determinism(self, rng):
        lat = _lat(4, rng)
        lut = schedules.bath_lookuptable(4, 1e-2)
        key = jax.random.key(5)
        confs = qmc.replicate(sa.random_state(key, lat.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 12)
        out, es = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                             lookuptable=lut, collect_energy=True)
        assert es.shape == (12, 2)
        assert np.allclose(
            np.asarray(es[-1]),
            np.asarray(qmc.best_slice_energy(lat, out)),
            atol=1e-4,
        )
        out2 = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                          lookuptable=lut)
        out3 = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key,
                          lookuptable=lut)
        assert np.array_equal(np.asarray(out2), np.asarray(out3))


class TestSolverDispatch:
    def test_sa_anneal_finds_ground_state_on_lattice(self, rng):
        lat = _lat(4, rng)
        e_gs, _ = brute_force_ground(lat)
        key = jax.random.key(0)
        s0 = sa.random_state(key, lat.nspins, batch=(16,))
        out = sa.anneal(lat, schedules.linear(3.0, 0.0, 400), s0, key)
        es = np.asarray(lat.energy(out))
        assert np.isclose(es.min(), e_gs, atol=1e-3), (es.min(), e_gs)
        assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}

    def test_sa_anneal_collect_energy_on_lattice(self, rng):
        lat = _lat(4, rng)
        key = jax.random.key(1)
        s0 = sa.random_state(key, lat.nspins, batch=(2,))
        out, es = sa.anneal(
            lat, schedules.linear(2.0, 0.1, 30), s0, key, collect_energy=True
        )
        assert es.shape == (30, 2)
        assert np.allclose(np.asarray(es[-1]), np.asarray(lat.energy(out)), atol=1e-4)

    def test_qmc_anneal_mst_protocol_on_lattice(self, rng):
        """Full benchmark protocol through solvers.qmc.anneal: LatticeProblem
        with even P dispatches to the split engine and must still find the
        brute-force ground state."""
        lat = _lat(4, rng)
        e_gs, _ = brute_force_ground(lat)
        pt, slices = 1.0, 8
        key = jax.random.key(2)
        k1, k2, k3 = jax.random.split(key, 3)
        s0 = sa.random_state(k1, lat.nspins, batch=(8,))
        s0 = sa.anneal(lat, schedules.pre_anneal_schedule(3.0, pt), s0, k2, mcsteps=5)
        confs = qmc.replicate(s0, slices)
        a = schedules.transverse_field(3.0, 1e-8, 400)
        confs = qmc.anneal(
            lat, a, jnp.ones_like(a), pt / slices, confs, k3, global_moves=True
        )
        best = np.asarray(qmc.best_slice_energy(lat, confs))
        assert np.isclose(best.min(), e_gs, atol=1e-3), (best.min(), e_gs)

    def test_qmc_bf16_state_bitwise_equals_f32(self, rng):
        """The scan carry defaults to bfloat16 storage (half the bytes,
        ops/split.qmc_anneal_split docstring). Spins are exactly +/-1 in
        bfloat16 and every dE/energy contraction promotes to float32
        before meeting the float32 couplings, so the trajectories must be
        BITWISE identical to float32 storage — including collected
        energies and global line moves, on a periodic lattice (live wrap
        slots)."""
        lat = _periodic_lat(6, rng, with_fields=True)
        key = jax.random.key(7)
        confs = qmc.replicate(sa.random_state(key, lat.nspins, batch=(3,)), 8)
        a = schedules.transverse_field(2.5, 1e-6, 60)
        b = jnp.ones_like(a)
        out = {}
        for dt in (jnp.float32, jnp.bfloat16):
            out[dt] = sp.qmc_anneal_split(
                lat, a, b, 0.2, confs, key,
                global_moves=True, collect_energy=True, state_dtype=dt,
            )
        (c32, e32), (c16, e16) = out[jnp.float32], out[jnp.bfloat16]
        assert c16.dtype == confs.dtype
        assert np.array_equal(np.asarray(c32), np.asarray(c16))
        # trajectories are the bitwise claim; the energy OBSERVABLE may
        # reorder its reduction per storage dtype (see the SA test below)
        np.testing.assert_allclose(np.asarray(e32), np.asarray(e16), rtol=1e-6)

    def test_sa_bf16_state_bitwise_equals_f32(self, rng):
        """Same bitwise-storage argument for the classical SA split engine
        (sa_anneal_split state_dtype)."""
        lat = _periodic_lat(6, rng, with_fields=True)
        key = jax.random.key(11)
        s0 = sa.random_state(key, lat.nspins, batch=(4,))
        temps = schedules.linear(3.0, 0.0, 80)
        out = {
            dt: sp.sa_anneal_split(
                lat, temps, s0, key, collect_energy=True, state_dtype=dt
            )
            for dt in (jnp.float32, jnp.bfloat16)
        }
        (s32, e32), (s16, e16) = out[jnp.float32], out[jnp.bfloat16]
        assert s16.dtype == s0.dtype
        assert np.array_equal(np.asarray(s32), np.asarray(s16))
        # the energy OBSERVABLE may differ in the last ULP: XLA fuses the
        # (promoted-f32) product into the reduction differently for the
        # two storage dtypes, reordering the sum. Trajectories above are
        # exact — SA dE is purely elementwise, no reductions.
        np.testing.assert_allclose(
            np.asarray(e32), np.asarray(e16), rtol=1e-6
        )

    @pytest.mark.parametrize("bath_update", ["sequential", "colored"])
    def test_qmc_bath_bf16_state_bitwise_equals_f32(self, rng, bath_update):
        """Bitwise bf16-storage transparency for both dissipative split
        engines (qmc_bath_anneal_split state_dtype): the bath einsums
        promote to float32 like every other contraction."""
        lat = _periodic_lat(4, rng, with_fields=True)
        key = jax.random.key(13)
        confs = qmc.replicate(sa.random_state(key, lat.nspins, batch=(2,)), 6)
        a = schedules.transverse_field(2.5, 1e-6, 30)
        lut = schedules.bath_lookuptable(6, 1e-2)
        out = {
            dt: sp.qmc_bath_anneal_split(
                lat, a, jnp.ones_like(a), 0.25, confs, key, lut,
                global_moves=True, collect_energy=True,
                bath_update=bath_update, state_dtype=dt,
            )
            for dt in (jnp.float32, jnp.bfloat16)
        }
        (c32, e32), (c16, e16) = out[jnp.float32], out[jnp.bfloat16]
        assert c16.dtype == confs.dtype
        assert np.array_equal(np.asarray(c32), np.asarray(c16))
        # same last-ULP latitude for the energy observable as the SA test
        np.testing.assert_allclose(np.asarray(e32), np.asarray(e16), rtol=1e-6)

    def test_qmc_anneal_collect_energy_on_lattice(self, rng):
        lat = _lat(4, rng)
        key = jax.random.key(3)
        confs = qmc.replicate(sa.random_state(key, lat.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 15)
        confs2, es = qmc.anneal(
            lat, a, jnp.ones_like(a), 0.25, confs, key, collect_energy=True
        )
        assert es.shape == (15, 2)
        assert np.allclose(
            np.asarray(es[-1]),
            np.asarray(qmc.best_slice_energy(lat, confs2)),
            atol=1e-4,
        )

    def test_qmc_anneal_odd_p_falls_back(self, rng):
        """Odd P on a lattice problem must route to the generic engine and
        still produce valid states."""
        lat = _lat(4, rng)
        key = jax.random.key(4)
        confs = qmc.replicate(sa.random_state(key, lat.nspins), 5)
        a = schedules.transverse_field(2.0, 1e-8, 20)
        out = qmc.anneal(lat, a, jnp.ones_like(a), 0.2, confs, key)
        assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}

    def test_deterministic_given_key(self, rng):
        lat = _lat(4, rng)
        key = jax.random.key(5)
        confs = qmc.replicate(sa.random_state(key, lat.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 20)
        x = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key)
        y = qmc.anneal(lat, a, jnp.ones_like(a), 0.25, confs, key)
        assert np.array_equal(np.asarray(x), np.asarray(y))


class TestSVMCSplit:
    def test_svmc_split_samples_rotor_gibbs(self):
        """The maskless split SVMC sweep must sample the continuous rotor
        Gibbs density of a 2x2 lattice (quadrature oracle on [0,pi]^4)."""
        from montecarlosolvers_tpu.ops import svmc_ops
        from montecarlosolvers_tpu.solvers import svmc

        lat = _lat(2, np.random.default_rng(31))
        sl = sp.build_split(lat)
        A, B, temp = 0.6, 1.0, 0.7

        jr = np.asarray(lat.j_right)
        jd = np.asarray(lat.j_down)
        # open 2x2: bonds (0,1) jr[0,0], (2,3) jr[1,0], (0,2) jd[0,0],
        # (1,3) jd[0,1]
        g = np.linspace(0, np.pi, 41)
        T = np.meshgrid(g, g, g, g, indexing="ij")
        c = [np.cos(t) for t in T]
        s = [np.sin(t) for t in T]
        E = B * (jr[0, 0] * c[0] * c[1] + jr[1, 0] * c[2] * c[3]
                 + jd[0, 0] * c[0] * c[2] + jd[0, 1] * c[1] * c[3])
        E = E - A * (s[0] + s[1] + s[2] + s[3])
        W = np.exp((E.min() - E) / temp)
        e_exact = float((W * E).sum() / W.sum())
        c0_exact = float((W * c[0]).sum() / W.sum())

        chains, nsweeps, burn = 256, 800, 200
        key = jax.random.key(0)
        th = svmc.random_state(key, 4, batch=(chains,))
        a0, b0 = sp.pack_classical(sl, th)

        @jax.jit
        def run(a, b, key):
            keys = jax.random.split(key, nsweeps)

            def body(carry, k):
                a, b = carry
                a, b = sp.svmc_split_sweep(sl, a, b, k, temp, A, B)
                th = sp.unpack_classical(sl, a, b)
                ct = jnp.cos(th)
                e = (
                    B * (jr[0, 0] * ct[:, 0] * ct[:, 1]
                         + jr[1, 0] * ct[:, 2] * ct[:, 3]
                         + jd[0, 0] * ct[:, 0] * ct[:, 2]
                         + jd[0, 1] * ct[:, 1] * ct[:, 3])
                    - A * jnp.sum(jnp.sin(th), axis=-1)
                )
                return (a, b), (e, ct[:, 0])

            _, (es, cs) = jax.lax.scan(body, (a, b), keys)
            return es, cs

        es, cs = run(a0, b0, jax.random.key(1))
        es = np.asarray(es)[burn:]
        cs = np.asarray(cs)[burn:]
        assert abs(es.mean() - e_exact) < 0.03, (es.mean(), e_exact)
        assert abs(cs.mean() - c0_exact) < 0.03, (cs.mean(), c0_exact)

    def test_svmc_solver_dispatches_to_split_and_finds_ground(self, rng):
        lat = _lat(4, rng)
        e_gs, _ = brute_force_ground(lat)
        from montecarlosolvers_tpu.solvers import svmc

        key = jax.random.key(7)
        th = svmc.random_state(key, lat.nspins, batch=(32,))
        a = schedules.linear(2.5, 1e-8, 600)
        out = svmc.anneal(lat, a, jnp.ones_like(a), 0.05, th, key, tf=True)
        es = np.asarray(lat.energy(svmc.z_projection(out)))
        assert np.isclose(es.min(), e_gs, atol=1e-3), (es.min(), e_gs)
        o = np.asarray(out)
        assert o.min() >= 0.0 and o.max() <= np.pi + 1e-6

    def test_svmc_split_collect_energy(self, rng):
        lat = _lat(4, rng)
        from montecarlosolvers_tpu.solvers import svmc

        key = jax.random.key(8)
        th = svmc.random_state(key, lat.nspins, batch=(3,))
        a = schedules.linear(2.0, 1e-8, 25)
        out, es = svmc.anneal(
            lat, a, jnp.ones_like(a), 0.1, th, key, collect_energy=True
        )
        assert es.shape == (25, 3)
        assert np.allclose(
            np.asarray(es[-1]),
            np.asarray(lat.energy(svmc.z_projection(out))),
            atol=1e-4,
        )
