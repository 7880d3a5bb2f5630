"""Machinery test for the PA-value experiment harness
(montecarlosolvers_tpu/bench/pa_value.py) on a tiny +-J lattice: every
arm runs end-to-end on CPU and returns well-formed records. The physics
claims come from running the study at benchmark scale on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import montecarlosolvers_tpu.bench.pa_value as pav
from montecarlosolvers_tpu.models.lattice import LatticeProblem


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setattr(pav, "REPLICAS", 32)
    monkeypatch.setattr(pav, "SWEEPS", 40)
    rng = np.random.default_rng(0)
    L = 6
    jr = jnp.asarray(rng.choice([-1.0, 1.0], (L, L)), jnp.float32)
    jd = jnp.asarray(rng.choice([-1.0, 1.0], (L, L)), jnp.float32)
    problem = LatticeProblem.from_planes(jr, jd)
    e_gs = -2.0 * L * L  # any certified lower bound: arms only need finite eps
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
    pav.sampling_arms(problem, e_gs, jax.random.key(1), rec, record)
    pa_arm, q_arm = rec["sampling_pa"], rec["sampling_quench"]
    assert pa_arm["total_sweeps"] == q_arm["total_sweeps"] == 32 * 40
    assert 0.0 < pa_arm["min_ess_frac"] <= 1.0
    assert np.isfinite(pa_arm["log_z_per_spin"])
    eq = [k for k in rec if k.startswith("sampling_quench_equalwall_s")]
    assert len(eq) == 1
    pt_arm = [k for k in rec if k.startswith("sampling_pt_matched_")]
    assert len(pt_arm) == 1 and rec[pt_arm[0]]["replicas"] >= 32
    for arm in rec.values():
        assert np.isfinite(arm["eps_cold"]) and arm["eps_cold"] > 0
        assert arm["wall_s"] > 0


def test_optimization_arms_equal_wall_scaling(tiny):
    problem, e_gs = tiny
    rec, record = _recorder()
    pav.optimization_arms(problem, e_gs, jax.random.key(2), rec, record)
    assert "opt_pa" in rec and "opt_sa_tau40" in rec
    eq = [k for k in rec if k.startswith("opt_sa_equalwall_tau")]
    assert len(eq) == 1
    assert rec[eq[0]]["tau"] >= 1
    assert any(k.startswith("opt_pt_matched_") for k in rec)
    for arm in rec.values():
        assert np.isfinite(arm["eps_best"])
        assert arm["eps_best"] <= arm["eps_mean"]
