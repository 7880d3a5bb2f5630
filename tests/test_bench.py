"""Unit tests for bench.py (no device needed): the slope math and its
degraded-fallback guard (VERDICT r2 #8: a wild two-point slope must not be
published), and the run's exit code, which is non-zero without a GPU or
when any arm raises."""

import json

import numpy as np
import pytest

import bench


class FakeClock:
    def __init__(self, t0=1000.0):
        self.now = t0

    def __call__(self):
        return self.now


def _with_fake_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(bench.time, "perf_counter", clock)
    return clock


def test_measure_rate_cancels_fixed_overhead(monkeypatch):
    clock = _with_fake_clock(monkeypatch)
    per_step, overhead, work = 1e-4, 0.3, 6400.0

    def run(tau, seed):
        clock.now += overhead + per_step * tau

    rate, info = bench._measure_rate(run, (1000, 3000, 5000), work)
    # slope timing must recover work/per_step exactly despite the 0.3 s
    # fixed overhead (one-shot at tau=1000 would be off by 75%)
    assert np.isclose(rate, work / per_step, rtol=1e-6)
    assert not info.get("degraded")
    assert info["points"] == 3


def test_measure_rate_degrades_on_wild_slope(monkeypatch):
    clock = _with_fake_clock(monkeypatch)
    work = 6400.0
    # pathological timings: a large-tau call that is FASTER than the
    # small-tau one makes the slope negative
    times = {100: 5.0, 300: 1.0}

    def run(tau, seed):
        clock.now += times[tau]

    rate, info = bench._measure_rate(run, (100, 300), work)
    assert info.get("degraded")
    # fallback is the conservative single-shot rate at the largest tau
    assert np.isclose(rate, work * 300 / times[300], rtol=1e-6)


def test_main_exits_nonzero_without_gpu(capsys):
    assert bench.main() == 1
    out, err = capsys.readouterr()
    assert "platform 'cpu'" in err
    assert out == ""


def test_cli_bench_subcommand_propagates_exit_code(capsys):
    from montecarlosolvers_tpu.__main__ import main

    assert main(["bench"]) == 1
    assert "no GPU" in capsys.readouterr().err


def _fake_gpu(monkeypatch, arms):
    from montecarlosolvers_tpu.utils import device

    info = {"platform": "gpu", "kind": "fake card", "count": 1}
    monkeypatch.setattr(device, "require_gpu", lambda: info)
    monkeypatch.setattr(device, "card", lambda: "fake card, 1.00 W")
    monkeypatch.setattr(bench, "_problem", lambda: None)
    monkeypatch.setattr(bench, "ARMS", arms)
    return info


def _good_arm(problem):
    return {"value": 1.0, "sa_attempts_per_sec": 1.0}


def _bad_arm(problem):
    raise RuntimeError("arm broke")


@pytest.mark.parametrize("arms,rc", [
    ((("sa", _good_arm),), 0),
    ((("sa", _good_arm), ("piqmc", _bad_arm)), 1),
])
def test_arm_failure_fails_the_run(monkeypatch, capsys, arms, rc):
    info = _fake_gpu(monkeypatch, arms)
    assert bench.main() == rc
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(lines) == len(arms) + 1
    for line in lines:  # every line names the device and the card
        assert line["device"] == info and line["card"] == "fake card, 1.00 W"
    final = lines[-1]
    assert final["value"] == 1.0 and final["instance"] == bench.INSTANCE
    assert final["failed_arms"] == ([] if rc == 0 else ["piqmc"])
    if rc:
        assert "arm broke" in final["error_piqmc"]


def test_problem_is_the_seeded_lattice():
    from montecarlosolvers_tpu.models import instances

    ref, _ = instances.random_2d_lattice(80, rng=0, lattice=True)
    got = bench._problem()
    assert got.nspins == 6400
    np.testing.assert_array_equal(np.asarray(got.energy(np.ones(6400))),
                                  np.asarray(ref.energy(np.ones(6400))))
