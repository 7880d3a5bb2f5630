"""chip_smoke.py on the CPU: its phases at tiny widths (the same checks it
runs on the card at full width), and its refusal to run without a GPU."""

import numpy as np
import pytest

import chip_smoke as cs
from montecarlosolvers_tpu.models import instances
from montecarlosolvers_tpu.reference import dense_energy, triplet_energy


@pytest.fixture
def report():
    return cs.Report()


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_exits_nonzero_without_gpu(argv, capsys):
    assert cs.main(argv) == 1
    out, err = capsys.readouterr()
    assert "FAIL [device] platform=cpu" in out
    assert "no GPU" in err
    assert '"ok": true' not in out


@pytest.mark.parametrize("method", list(cs.SOLVE_PRESETS))
def test_solve_preset_energies_match_float64(method, report):
    problem, (rows, cols, vals) = instances.random_2d_lattice(
        6, rng=0, lattice=True)
    _, kw = cs.SOLVE_PRESETS[method]
    kw = {"slices": 4} if "slices" in kw else {}
    assert cs.solve_check(report, problem,
                          lambda s: triplet_energy(s, rows, cols, vals),
                          method, 4, 5, "lattice6", **kw)
    assert report.failed == []


@pytest.mark.parametrize("method", cs.DENSE_METHODS)
def test_dense_solve_energies_match_float64(method, report):
    sk, _ = instances.sk_model(24, rng=0)
    J, h = np.asarray(sk.J), np.asarray(sk.h)
    assert cs.solve_check(report, sk, lambda s: dense_energy(s, J, h),
                          method, 4, 5, "sk24")


def test_solve_check_fails_on_wrong_reference(report, capsys):
    problem, (rows, cols, vals) = instances.random_2d_lattice(
        4, rng=0, lattice=True)
    assert not cs.solve_check(
        report, problem, lambda s: triplet_energy(s, rows, cols, -vals),
        "sa", 4, 5, "lattice4")
    assert report.failed == ["solve:lattice4:sa"]
    assert "FAIL [solve:lattice4:sa]" in capsys.readouterr().out


def test_triplet_energy_matches_classical_ising_energy():
    from montecarlosolvers_tpu.models.ising import classical_ising_energy

    _, (rows, cols, vals) = instances.random_2d_lattice(
        4, rng=3, with_fields=True)
    J = np.zeros((16, 16))
    J[rows, cols] = vals
    s = np.random.default_rng(0).choice([-1.0, 1.0], size=(5, 16))
    np.testing.assert_allclose(
        triplet_energy(s, rows, cols, vals),
        [classical_ising_energy(x, J) for x in s], rtol=1e-12)


def test_entry_phase_runs_cli_in_process(report):
    assert cs.entry_phase(report, L=6, reads=4, sweeps=5, slices=4)


def test_bench_phase_compares_engines_with_cpu(report, capsys):
    assert cs.bench_phase(report, L=6, P=4, taus=(10, 5, 5, 5),
                          chains=(16, 4, 8, 4), cpu_chains=4)
    out = capsys.readouterr().out
    for name in ("sa", "piqmc", "svmc", "piqmc_bath"):
        assert f"PASS [bench:{name}]" in out
    assert "attempts_per_s=" in out and "temp_size_in_bytes" in out


def test_prng_and_bath_precision_phases(report):
    rates = cs.prng_phase(report, L=6, tau=10, chains=8)
    assert set(rates) == {"threefry2x32", "rbg"}
    rates = cs.bath_pin_phase(report, L=6, P=4, tau=5, chains=4)
    assert set(rates) == {"highest", "default"}
    assert report.failed == []


def test_cluster_phase(report, capsys):
    assert cs.cluster_phase(report, L=4)
    out = capsys.readouterr().out
    assert "wolff_cluster_ms=" in out and "sw_full_sweep_ms=" in out


def test_bath_precision_restores_the_pin():
    import jax
    from montecarlosolvers_tpu.ops import piqmc, split

    with cs.bath_precision(jax.lax.Precision.DEFAULT):
        assert split.BATH_PRECISION == jax.lax.Precision.DEFAULT
    assert split.BATH_PRECISION == piqmc.BATH_PRECISION == jax.lax.Precision.HIGHEST


def test_oracle_phase_small(report):
    assert cs.oracle_phase(report, L=8, sa_cfg=(100, 128),
                           q_cfg=(4, 100, 64), v_cfg=(100, 128))


def test_gibbs_phase(report):
    assert cs.gibbs_phase(report)


def test_dense_field_phase(report, capsys):
    assert cs.dense_field_phase(report, n=128, reads=8)
    assert "field_rel_err_default_precision=" in capsys.readouterr().out


@pytest.mark.parametrize("shift,ok", [(0.0, True), (0.01, True), (5.0, False)])
def test_within_se(shift, ok):
    x = np.random.default_rng(0).normal(size=400)
    y = np.random.default_rng(1).normal(size=400) + shift
    gap, bound = cs.within_se(x, y)
    assert (gap <= bound) == ok
    assert np.isclose(bound, 4.0 * np.sqrt(x.var(ddof=1) / 400
                                           + y.var(ddof=1) / 400))


def test_four_card_phase_on_virtual_devices(report):
    """The --four-cards path rehearsed on four virtual CPU devices."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    assert cs.four_card_phase(report, L=6, sa_cfg=(16, 10),
                              q_cfg=(4, 8, 5), trotter_cfg=(8, 32, 30))
