"""Machinery test for the PT-value experiment harness
(montecarlosolvers_tpu/bench/pt_value.py) on a tiny +-J lattice: every
arm runs end-to-end on CPU and returns well-formed records. The physics
claims come from running the study at benchmark scale on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import montecarlosolvers_tpu.bench.pt_value as pv
from montecarlosolvers_tpu.models.lattice import LatticeProblem


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(pv, "RUNGS", 6)
    monkeypatch.setattr(pv, "SWEEPS", 30)
    monkeypatch.setattr(pv, "Q_RUNGS", 4)
    monkeypatch.setattr(pv, "Q_SLICES", 4)
    monkeypatch.setattr(pv, "Q_SWEEPS", 20)
    rng = np.random.default_rng(0)
    L = 6
    jr = jnp.asarray(rng.choice([-1.0, 1.0], (L, L)), jnp.float32)
    jd = jnp.asarray(rng.choice([-1.0, 1.0], (L, L)), jnp.float32)
    problem = LatticeProblem.from_planes(jr, jd)
    # any certified lower bound works: the arms only need finite eps
    e_gs = -2.0 * L * L
    return problem, e_gs


def _recorder():
    rec = {}

    def record(name, fn):
        out = fn()
        rec[name] = out
        return out

    return rec, record


def test_sampling_arms_record_shape(tiny):
    problem, e_gs = tiny
    rec, record = _recorder()
    pv.sampling_arms(problem, e_gs, jax.random.key(1), rec, record)
    pt_arm, q_arm = rec["sampling_pt"], rec["sampling_quench"]
    assert 0.0 < pt_arm["swap_rate"] <= 1.0
    assert pt_arm["total_sweeps"] == q_arm["total_sweeps"] == 6 * 30
    for arm in (pt_arm, q_arm):
        assert np.isfinite(arm["eps_cold"]) and arm["eps_cold"] > 0
        assert arm["wall_s"] > 0


def test_optimization_arms_equal_wall_scaling(tiny):
    problem, e_gs = tiny
    rec, record = _recorder()
    pv.optimization_arms(problem, e_gs, jax.random.key(2), rec, record)
    assert "opt_pt" in rec and "opt_sa_tau30" in rec
    eq = [k for k in rec if k.startswith("opt_sa_equalwall_tau")]
    assert len(eq) == 1
    # equal-wall tau derives from the measured wall ratio
    tau_eq = rec[eq[0]]["tau"]
    assert tau_eq >= 1
    for arm in rec.values():
        assert np.isfinite(arm["eps_best"])


def test_quantum_arms_run(tiny):
    problem, e_gs = tiny
    rec, record = _recorder()
    pv.quantum_arms(problem, e_gs, jax.random.key(3), rec, record)
    assert 0.0 <= rec["quantum_pt"]["swap_rate"] <= 1.0
    assert any(k.startswith("quantum_piqmc_equalwall") for k in rec)
    for arm in rec.values():
        assert np.isfinite(arm["eps_best"])


def test_icm_arms_record_shape(tiny):
    problem, e_gs = tiny
    rec, record = _recorder()
    pv.icm_arms(problem, e_gs, jax.random.key(4), rec, record)
    for name in ("sampling_icm", "opt_icm"):
        arm = rec[name]
        assert 0.0 <= arm["houdayer_flip_frac"] <= 1.0
        assert 0.0 <= arm["swap_rate"] <= 1.0
        assert arm["wall_s"] > 0
    assert np.isfinite(rec["sampling_icm"]["eps_cold"])
    assert np.isfinite(rec["opt_icm"]["eps_best"])
