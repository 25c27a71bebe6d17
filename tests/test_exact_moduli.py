"""Plain-path accuracy against the exact big-int product for every moduli
count 2-20: bit-identical (exactly rounded) at 20 moduli, inside the
normwise band below that, in fast and accurate mode."""

import numpy as np
import pytest

import gemmul8_tpu as g8

from exactness import SHAPES, band, exact, normwise_err, operands


@pytest.mark.parametrize("num_moduli", range(2, 21))
def test_f64_fast_every_moduli_count(num_moduli):
    a, b = operands(SHAPES["ragged"], "f64")
    ex, scale = exact(a, b)
    c = np.asarray(g8.gemm(a, b, num_moduli=num_moduli))
    assert c.dtype == np.float64
    if num_moduli == 20:
        np.testing.assert_array_equal(c, ex)
    assert normwise_err(c, ex, scale) <= band(num_moduli)


@pytest.mark.parametrize("num_moduli", range(2, 21, 2))
def test_f64_accurate_moduli_counts(num_moduli):
    a, b = operands(SHAPES["m_eq_k"], "f64", seed=1)
    ex, scale = exact(a, b)
    c = np.asarray(g8.gemm(a, b, num_moduli=num_moduli, fastmode=False))
    if num_moduli == 20:
        np.testing.assert_array_equal(c, ex)
    assert normwise_err(c, ex, scale) <= band(num_moduli)
