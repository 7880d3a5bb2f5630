"""PIQMC solver tests: MST-protocol ground-state search on brute-forced
instances, extended-Hamiltonian energy monotonicity at T -> 0, dissipative
and global-move variants, and state invariants."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.solvers import sa, qmc
from montecarlosolvers_tpu.ops import piqmc as piqmc_ops
from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.reference import extended_energy
from tests.test_sa import brute_force_ground


class TestLocalSweep:
    def test_energy_nonincreasing_at_zero_temp(self, rng):
        """At T_eff -> 0 the Metropolis rule only takes downhill moves, so
        the extended Hamiltonian must never increase across sweeps."""
        prob, _ = instances.random_2d_lattice(4, rng=rng)
        slices = 6
        key = jax.random.key(0)
        s0 = sa.random_state(key, prob.nspins)
        confs = qmc.replicate(s0, slices)
        # flip a few spins so replicas differ
        confs = confs.at[2, :5].multiply(-1.0)
        temp, gamma = 1e-6, 1.0
        e_prev = float(extended_energy(prob, confs, temp, gamma))
        for i in range(5):
            key, k = jax.random.split(key)
            confs = piqmc_ops.local_sweep(prob, confs, k, temp, gamma, 1.0)
            e = float(extended_energy(prob, confs, temp, gamma))
            assert e <= e_prev + 1e-3, (i, e, e_prev)
            e_prev = e

    def test_dissipative_energy_nonincreasing_at_zero_temp(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        slices = 5
        key = jax.random.key(1)
        s0 = sa.random_state(key, prob.nspins)
        confs = qmc.replicate(s0, slices)
        confs = confs.at[1, :4].multiply(-1.0)
        temp, gamma = 1e-6, 0.8
        lut = schedules.bath_lookuptable(slices, 1e-2)
        bm = piqmc_ops.bath_matrix(lut, slices)
        e_prev = float(extended_energy(prob, confs, temp, gamma, lookuptable=lut))
        for i in range(4):
            key, k = jax.random.split(key)
            confs = piqmc_ops.dissipative_local_sweep(
                prob, confs, k, temp, gamma, 1.0, bm
            )
            e = float(extended_energy(prob, confs, temp, gamma, lookuptable=lut))
            assert e <= e_prev + 1e-3, (i, e, e_prev)
            e_prev = e

    def test_global_moves_energy_nonincreasing_at_zero_temp(self, rng):
        prob, _ = instances.random_2d_lattice(4, rng=rng)
        slices = 4
        key = jax.random.key(2)
        confs = qmc.replicate(sa.random_state(key, prob.nspins), slices)
        temp = 1e-6
        # line flips only change the classical part
        e_prev = float(jnp.sum(prob.energy(confs)))
        for _ in range(3):
            key, k = jax.random.split(key)
            confs = piqmc_ops.global_line_moves(prob, confs, k, temp, 1.0)
            e = float(jnp.sum(prob.energy(confs)))
            assert e <= e_prev + 1e-3
            e_prev = e


class TestSpacetimeColoring:
    def test_phase_counts(self):
        from montecarlosolvers_tpu.ops.piqmc import spacetime_num_phases

        assert spacetime_num_phases(2, 40) == 2   # bipartite, even P
        assert spacetime_num_phases(2, 10) == 2
        assert spacetime_num_phases(2, 5) == 3    # (5-1) % 2 == 0 -> bump
        assert spacetime_num_phases(3, 8) == 3    # (8-1) % 3 != 0

    def test_partition_is_conflict_free(self, rng):
        """No two interacting sites (spatial edge in a slice, or Trotter
        ring neighbors of one spin) may share a phase."""
        from montecarlosolvers_tpu.ops.piqmc import spacetime_num_phases

        for P in (2, 4, 5, 7, 10):
            prob, (rows, cols, vals) = instances.random_graph(
                12, 20, rng=np.random.default_rng(P)
            )
            colors = np.argmax(np.asarray(prob.color_masks), axis=0)
            m = spacetime_num_phases(prob.num_colors, P)
            phase = (colors[None, :] + np.arange(P)[:, None]) % m
            for a, b in zip(rows, cols):
                if a != b:
                    assert (phase[:, a] != phase[:, b]).all(), (P, a, b)
            for k in range(P):
                k2 = (k + 1) % P
                if k2 != k:
                    assert (phase[k] != phase[k2]).all(), (P, k)

    def test_extended_gibbs_distribution(self, rng):
        """The space-time colored local sweep must sample the exact
        Boltzmann distribution of the extended PIQMC Hamiltonian
        (enumerable: N=2 spins x P=2 slices = 16 states)."""
        prob = __import__(
            "montecarlosolvers_tpu.models.ising", fromlist=["IsingProblem"]
        ).IsingProblem.from_edges(2, [0], [1], [0.9], maxnb=1)
        slices, temp, gamma, b = 2, 0.8, 0.7, 1.0
        teff = temp * slices

        # exact distribution over all (P, N) states
        states = []
        for bits in range(16):
            s = np.array([(bits >> i) & 1 for i in range(4)]) * 2 - 1
            states.append(s.reshape(2, 2).astype(np.float32))
        states = jnp.asarray(np.stack(states))  # (16, P, N)
        es = np.asarray(extended_energy(prob, states, temp, gamma, b=b))
        w = np.exp(-es / teff)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 48, 1200, 200
        key = jax.random.key(0)
        confs0 = jnp.where(
            jax.random.bernoulli(key, 0.5, (chains, 2, 2)), 1.0, -1.0
        )

        @jax.jit
        def run(confs, key):
            keys = jax.random.split(key, nsweeps)

            def body(c, k):
                c = piqmc_ops.local_sweep(prob, c, k, temp, gamma, b)
                bits = (c > 0).astype(jnp.int32).reshape(c.shape[0], 4)
                idx = bits @ jnp.asarray([1, 2, 4, 8])
                return c, idx

            _, idxs = jax.lax.scan(body, confs, keys)
            return idxs

        idxs = np.asarray(run(confs0, key))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=16)
        p_emp = counts / counts.sum()
        assert np.max(np.abs(p_emp - p_exact)) < 0.01, (p_emp, p_exact)


class TestDissipativeGibbs:
    def test_dissipative_sweep_samples_extended_gibbs(self, rng):
        """Slice-sequential dissipative sweep must sample the exact
        Boltzmann distribution of the bath-extended Hamiltonian
        (N=2, P=2, 16 states)."""
        from montecarlosolvers_tpu.models.ising import IsingProblem

        prob = IsingProblem.from_edges(2, [0], [1], [0.8], maxnb=1)
        slices, temp, gamma, b = 2, 0.9, 0.6, 1.0
        teff = temp * slices
        lut = schedules.bath_lookuptable(slices, 0.05)
        bath_mat = piqmc_ops.bath_matrix(lut, slices)

        states = []
        for bits in range(16):
            s = np.array([(bits >> i) & 1 for i in range(4)]) * 2 - 1
            states.append(s.reshape(2, 2).astype(np.float32))
        states = jnp.asarray(np.stack(states))
        es = np.asarray(
            extended_energy(prob, states, temp, gamma, b=b, lookuptable=lut)
        )
        w = np.exp(-es / teff)
        p_exact = w / w.sum()

        chains, nsweeps, burn = 48, 1200, 200
        key = jax.random.key(8)
        confs0 = jnp.where(
            jax.random.bernoulli(key, 0.5, (chains, 2, 2)), 1.0, -1.0
        )

        @jax.jit
        def run(confs, key):
            keys = jax.random.split(key, nsweeps)

            def body(c, k):
                c = piqmc_ops.dissipative_local_sweep(
                    prob, c, k, temp, gamma, b, bath_mat
                )
                bits = (c > 0).astype(jnp.int32).reshape(c.shape[0], 4)
                idx = bits @ jnp.asarray([1, 2, 4, 8])
                return c, idx

            _, idxs = jax.lax.scan(body, confs, keys)
            return idxs

        idxs = np.asarray(run(confs0, key))[burn:]
        counts = np.bincount(idxs.ravel(), minlength=16)
        p_emp = counts / counts.sum()
        # ~48k correlated samples: 3-sigma of a p~0.38 bin is ~0.012
        assert np.max(np.abs(p_emp - p_exact)) < 0.015, (p_emp, p_exact)


class TestAnneal:
    def test_mst_protocol_finds_ground_state(self, rng):
        """Full benchmark protocol (examples/santoro80.py:269-296) on a
        brute-forced 4x4 instance: pre-anneal, replicate, PIQMC with global
        moves, best-slice readout."""
        prob, _ = instances.random_2d_lattice(4, rng=rng)
        e_gs, _ = brute_force_ground(prob)
        pt, slices = 1.0, 8
        temp = pt / slices
        key = jax.random.key(0)
        k1, k2, k3 = jax.random.split(key, 3)
        s0 = sa.random_state(k1, prob.nspins, batch=(8,))
        pre = schedules.pre_anneal_schedule(3.0, pt)
        s0 = sa.anneal(prob, pre, s0, k2, mcsteps=5)
        confs = qmc.replicate(s0, slices)
        a = schedules.transverse_field(3.0, 1e-8, 400)
        b = jnp.ones_like(a)
        confs = qmc.anneal(prob, a, b, temp, confs, k3, global_moves=True)
        best = np.asarray(qmc.best_slice_energy(prob, confs))
        assert np.isclose(best.min(), e_gs, atol=1e-3), (best.min(), e_gs)

    def test_deterministic_given_key(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        key = jax.random.key(4)
        confs = qmc.replicate(sa.random_state(key, prob.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 20)
        b = jnp.ones_like(a)
        x = qmc.anneal(prob, a, b, 0.25, confs, key)
        y = qmc.anneal(prob, a, b, 0.25, confs, key)
        assert np.array_equal(np.asarray(x), np.asarray(y))

    def test_odd_slice_count(self, rng):
        """P=5 exercises the 3-color Trotter ring (benchmark uses P=5)."""
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        key = jax.random.key(5)
        confs = qmc.replicate(sa.random_state(key, prob.nspins), 5)
        a = schedules.transverse_field(2.0, 1e-8, 30)
        confs = qmc.anneal(prob, a, jnp.ones_like(a), 0.2, confs, key)
        assert set(np.unique(np.asarray(confs))) <= {-1.0, 1.0}

    def test_collect_energy_best_slice(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        key = jax.random.key(6)
        confs = qmc.replicate(sa.random_state(key, prob.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 15)
        confs2, es = qmc.anneal(
            prob, a, jnp.ones_like(a), 0.25, confs, key, collect_energy=True
        )
        assert es.shape == (15, 2)
        assert np.allclose(
            np.asarray(es[-1]), np.asarray(qmc.best_slice_energy(prob, confs2))
        )


class TestClusterVariants:
    def test_wolff_flips_one_connected_component(self, rng):
        """The flipped set must be a single connected component of the
        space-time interaction graph (mixed signs allowed: satisfied
        antiferromagnetic bonds join opposite-sign spins)."""
        from montecarlosolvers_tpu.ops.cluster import wolff_update

        prob, _ = instances.random_2d_lattice(4, rng=rng)
        slices = 4
        key = jax.random.key(0)
        confs = qmc.replicate(sa.random_state(key, prob.nspins), slices)
        out = wolff_update(prob, confs, key, 0.25, 1.5, 1.0)
        flipped = np.asarray(out != confs)  # (P, N)
        assert flipped.sum() >= 1
        assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}

        # BFS over spatial + temporal adjacency restricted to flipped sites
        nbr = np.asarray(prob.nbr_idx)
        sites = {tuple(x) for x in np.argwhere(flipped)}
        start = next(iter(sites))
        seen, stack = {start}, [start]
        while stack:
            k, i = stack.pop()
            cands = [((k + 1) % slices, i), ((k - 1) % slices, i)]
            cands += [(k, int(j)) for j in nbr[i] if int(j) != i]
            for cand in cands:
                if cand in sites and cand not in seen:
                    seen.add(cand)
                    stack.append(cand)
        assert seen == sites, "flipped set is not one connected component"

    def test_wolff_anneal_variants_run(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        key = jax.random.key(1)
        confs = qmc.replicate(sa.random_state(key, prob.nspins, batch=(2,)), 4)
        a = schedules.transverse_field(2.0, 1e-8, 10)
        b = jnp.ones_like(a)
        for kwargs in (
            dict(rule="local"),
            dict(rule="full"),
            dict(rule="local", lookuptable=schedules.bath_lookuptable(4, 1e-2)),
        ):
            out = qmc.anneal_wolff(prob, a, b, 0.25, confs, key, **kwargs)
            assert out.shape == confs.shape
            assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}

    def test_sw_bath_zero_coupling_is_identityless_single_flips(self, rng):
        """With lut = 0 every bath bond has p = 0, so clusters are single
        (seed) sites and the move reduces to per-line Metropolis."""
        from montecarlosolvers_tpu.ops.cluster import sw_bath_sweep

        prob, _ = instances.random_2d_lattice(3, rng=rng)
        slices = 4
        key = jax.random.key(2)
        confs = qmc.replicate(sa.random_state(key, prob.nspins), slices)
        lut = jnp.zeros(slices - 1)
        out = sw_bath_sweep(prob, confs, key, 0.25, 1.0, 1.0, lut)
        assert set(np.unique(np.asarray(out))) <= {-1.0, 1.0}

    def test_sw_bath_anneal_finds_low_energy(self, rng):
        prob, _ = instances.random_2d_lattice(3, rng=rng)
        e_gs, _ = brute_force_ground(prob)
        key = jax.random.key(3)
        pt, slices = 1.0, 6
        s0 = sa.random_state(key, prob.nspins, batch=(4,))
        confs = qmc.replicate(s0, slices)
        a = schedules.transverse_field(2.5, 1e-8, 150)
        lut = schedules.bath_lookuptable(slices, 1e-3)
        out = qmc.anneal_sw_bath(
            prob, a, jnp.ones_like(a), pt / slices, lut, confs, key,
            per_slice_seeds=False,
        )
        best = float(np.min(np.asarray(qmc.best_slice_energy(prob, out))))
        # local sweeps + clusters should get close to the ground state
        assert best <= e_gs + 0.15 * abs(e_gs), (best, e_gs)
