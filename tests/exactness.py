"""Shared helpers for the plain-path exactness tests: operands with zeros
and ragged shapes, the exact big-int product, and the normwise error band
of an L-moduli emulation."""

import numpy as np

from gemmul8_tpu.bench.matrices import exact_gemm_f64, phi_matrix

# (m, k, n): ragged and unaligned, k = 1, and m == k
SHAPES = {"ragged": (5, 37, 3), "k1": (17, 1, 9), "m_eq_k": (12, 12, 7),
          "unaligned": (9, 70, 13)}


def operands(shape, dtype: str, seed: int = 0):
    """phi = 1 operands with a sprinkling of exact zeros. dtype: 'f64',
    'f32' (both f32) or 'mixed' (f64 x f32)."""
    m, k, n = shape
    a = phi_matrix(m, k, 1.0, seed=seed + m)
    b = phi_matrix(k, n, 1.0, seed=seed + 100 + n)
    a.ravel()[::7] = 0.0
    if dtype == "f32":
        a = a.astype(np.float32)
    if dtype in ("f32", "mixed"):
        b = b.astype(np.float32)
    return a, b


def exact(a, b):
    """(exact product rounded once to f64, |A| @ |B|)."""
    a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return exact_gemm_f64(a64, b64), np.abs(a64) @ np.abs(b64)


def band(num_moduli: int) -> float:
    """Bound on |C - AB| / (|A| @ |B|) elementwise for an L-moduli
    emulation: ~3.9 bits per modulus (measured 2^-(3.9 L - 6) on CPU),
    with 4 bits of margin, floored at one f64 rounding."""
    return max(2.0 ** -(3.9 * num_moduli - 10), 2.0 ** -52)


def normwise_err(c, ex, scale) -> float:
    d = np.abs(np.asarray(c, np.float64) - ex)
    return float(np.max(np.where(scale > 0, d / np.where(scale > 0, scale,
                                                         1.0), d)))
