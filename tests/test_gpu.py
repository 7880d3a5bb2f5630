"""Checks that only mean something on the card: full-float32 contractions
(a DEFAULT-precision f32 dot may run in TF32 there) and the split engine's
exact Gibbs sampling as the GPU compiler builds it."""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_dense_fields_full_float32(gpu):
    assert cs.dense_field_phase(cs.Report(), n=1024)


def test_exact_gibbs_histograms(gpu):
    assert cs.gibbs_phase(cs.Report())
