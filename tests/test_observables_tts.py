"""TTS metric and success-probability helpers."""

import numpy as np

from montecarlosolvers_tpu.utils import observables as obs


class TestTTS:
    def test_success_probability(self):
        es = np.array([-10.0, -9.0, -10.0, -8.0])
        assert obs.success_probability(es, -10.0) == 0.5

    def test_tts_limits(self):
        assert obs.time_to_solution(100, 0.0) == float("inf")
        assert obs.time_to_solution(100, 1.0) == 100.0

    def test_tts_formula(self):
        # p = 0.5, 99% confidence: tau * ln(0.01)/ln(0.5) ~ tau * 6.64
        tts = obs.time_to_solution(100, 0.5)
        assert np.isclose(tts, 100 * np.log(0.01) / np.log(0.5))
        # higher success -> lower TTS
        assert obs.time_to_solution(100, 0.9) < tts
