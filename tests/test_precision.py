"""Every float32 contraction over arbitrary couplings or bath rows asks
for full float32 (Precision.HIGHEST): on a GPU a DEFAULT-precision f32
dot may run in TF32 (about three decimal digits), which would perturb
local fields, dE and the acceptance decisions. Checked in the lowered
program of each call site."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from montecarlosolvers_tpu import schedules
from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.ops import cluster, dense_sweep, piqmc, split
from montecarlosolvers_tpu.solvers import qmc, sa

P, TEMP, GAMMA, B = 4, 0.25, 1.0, 1.0
KEY = jax.random.key(0)


def _lattice():
    return instances.random_2d_lattice(4, rng=0, lattice=True)[0]


def _confs(n, chains=2):
    return qmc.replicate(sa.random_state(KEY, n, batch=(chains,)), P)


def _bath():
    return piqmc.bath_matrix(schedules.bath_lookuptable(P, 0.1), P)


def _dense_fields():
    sk, _ = instances.sk_model(16, rng=0)
    return jax.jit(sk.local_fields).lower(sa.random_state(KEY, 16, (2,)))


def _dense_energy():
    sk, _ = instances.sk_model(16, rng=0)
    return jax.jit(sk.energy).lower(sa.random_state(KEY, 16, (2,)))


def _dense_sweep():
    sk, _ = instances.sk_model(16, rng=0)
    return jax.jit(lambda s, k: dense_sweep.dense_metropolis_sweep(
        sk, s, k, 1.0)).lower(sa.random_state(KEY, 16, (2,)), KEY)


def _piqmc_sequential_bath():
    prob = _lattice().to_generic()
    return jax.jit(lambda c, k: piqmc.dissipative_local_sweep(
        prob, c, k, TEMP, GAMMA, B, _bath())).lower(_confs(16), KEY)


def _piqmc_colored_bath():
    prob = _lattice().to_generic()
    return jax.jit(lambda c, k: piqmc.dissipative_colored_sweep(
        prob, c, k, TEMP, GAMMA, B, _bath())).lower(_confs(16), KEY)


def _split_sequential_bath():
    sl = split.build_split(_lattice())
    a, b = split.pack_classical(sl, _confs(16))
    return jax.jit(lambda a, b, k: split.qmc_bath_split_sweep(
        sl, a, b, k, TEMP, GAMMA, B, _bath())).lower(a, b, KEY)


def _split_colored_bath():
    sl = split.build_split(_lattice())
    state = split.pack_qmc(sl, _confs(16))
    return jax.jit(lambda s, k: split.qmc_bath_split_colored_sweep(
        sl, *s, k, TEMP, GAMMA, B, _bath())).lower(state, KEY)


def _trotter_sharded_bath():
    from montecarlosolvers_tpu.parallel import make_mesh, trotter

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    prob = _lattice().to_generic()
    lut = schedules.bath_lookuptable(P, 0.1)
    a = schedules.transverse_field(2.0, 1e-8, 2)
    mesh = make_mesh(replica=2)
    return jax.jit(lambda c, k: trotter.anneal_sharded(
        prob, a, jnp.ones_like(a), TEMP, c, k, mesh, lookuptable=lut,
    )).lower(_confs(16), KEY)


def _cluster_bath_phase():
    prob = _lattice().to_generic()
    lut = schedules.bath_lookuptable(P, 0.1)
    confs = _confs(16, chains=1)[0]
    return jax.jit(lambda c, k: cluster.bath_cluster_phase(
        prob, c, k, TEMP, GAMMA, B, lut, jnp.zeros(16, jnp.int32),
        jnp.ones(16, bool))).lower(confs, KEY)


def _cluster_sw_full_phase():
    prob = _lattice().to_generic()
    lut = schedules.bath_lookuptable(P, 0.1)
    confs = _confs(16, chains=1)[0]
    return jax.jit(lambda c, k: cluster.sw_full_phase(
        prob, c, k, TEMP, GAMMA, B, lut, jnp.ones(16, bool))).lower(confs, KEY)


@pytest.mark.parametrize("lower", [
    _dense_fields, _dense_energy, _dense_sweep, _piqmc_sequential_bath,
    _piqmc_colored_bath, _split_sequential_bath, _split_colored_bath,
    _trotter_sharded_bath, _cluster_bath_phase, _cluster_sw_full_phase,
], ids=lambda f: f.__name__.lstrip("_"))
def test_contraction_pins_highest(lower):
    text = lower().as_text()
    assert "dot_general" in text
    assert "precision = [HIGHEST, HIGHEST]" in text


def test_bfloat16_dense_sweep_keeps_default_precision():
    """matmul_dtype=bfloat16 is the opt-in low-precision route."""
    sk, _ = instances.sk_model(16, rng=0)
    text = jax.jit(lambda s, k: dense_sweep.dense_metropolis_sweep(
        sk, s, k, 1.0, matmul_dtype=jnp.bfloat16)).lower(
            sa.random_state(KEY, 16, (2,)), KEY).as_text()
    assert "dot_general" in text and "HIGHEST" not in text


def test_pinned_dense_fields_match_float64():
    sk, _ = instances.sk_model(256, rng=1)
    s = sa.random_state(KEY, 256, (8,))
    f64 = np.asarray(s, np.float64) @ np.asarray(sk.J, np.float64) + np.asarray(
        sk.h, np.float64)
    err = np.max(np.abs(np.asarray(sk.local_fields(s)) - f64)) / np.max(
        np.abs(f64))
    assert err <= 1e-5
