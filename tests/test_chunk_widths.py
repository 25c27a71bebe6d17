"""The moduli-chunked (low-memory) schedule is bit-identical to one-shot
for every chunk width 1..L."""

import numpy as np
import pytest

from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.types import f64_to_bits

from exactness import SHAPES, operands

_ONE_SHOT = {}


def _one_shot(key, a, b, num_moduli, fastmode, kind):
    if key not in _ONE_SHOT:
        _ONE_SHOT[key] = gg.gemm_core(a, b, num_moduli, fastmode, kind)
    return _ONE_SHOT[key]


@pytest.mark.parametrize("width", range(1, 15))
def test_f64_fast_chunk_width(width):
    a, b = operands(SHAPES["unaligned"], "f64", seed=4)
    A, B = f64_to_bits(a), f64_to_bits(b)
    ref = _one_shot("f64", A, B, 14, True, "f64")
    got = gg.gemm_core(A, B, 14, True, "f64", moduli_chunk=width)
    np.testing.assert_array_equal(np.asarray(got.hi), np.asarray(ref.hi))
    np.testing.assert_array_equal(np.asarray(got.lo), np.asarray(ref.lo))


@pytest.mark.parametrize("width", range(1, 9))
def test_f32_accurate_chunk_width(width):
    a, b = operands(SHAPES["ragged"], "f32", seed=5)
    ref = _one_shot("f32", a, b, 8, False, "f32")
    got = gg.gemm_core(a, b, 8, False, "f32", moduli_chunk=width)
    np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                  np.asarray(ref).view(np.uint32))
