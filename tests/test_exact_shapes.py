"""Plain-path exactness over shapes (ragged, k = 1, m == k, unaligned),
operand dtypes (f64, f32, mixed) and modes: at 20 moduli with f64 output
the result is the exact product rounded once; f32 output at 8 moduli stays
inside the band plus one f32 rounding."""

import numpy as np
import pytest

import gemmul8_tpu as g8

from exactness import SHAPES, band, exact, operands


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("dtype", ["f64", "f32", "mixed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_exact_at_20_moduli(shape, dtype, fastmode):
    a, b = operands(SHAPES[shape], dtype, seed=2)
    ex, _ = exact(a, b)
    c = np.asarray(g8.gemm(a, b, num_moduli=20, fastmode=fastmode,
                           out_dtype=np.float64))
    assert c.dtype == np.float64 and c.shape == ex.shape
    np.testing.assert_array_equal(c, ex)


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_f32_out_at_8_moduli(shape, fastmode):
    a, b = operands(SHAPES[shape], "f32", seed=3)
    ex, scale = exact(a, b)
    c = np.asarray(g8.gemm(a, b, num_moduli=8, fastmode=fastmode))
    assert c.dtype == np.float32
    d = np.abs(c.astype(np.float64) - ex)
    allowed = band(8) * scale + 2.0 ** -24 * np.abs(ex)
    assert np.all(d <= allowed), float(np.max(d - allowed))
