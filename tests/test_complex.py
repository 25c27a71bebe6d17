"""Complex GEMM emulation: all three strategies must agree with a
high-precision reference, and BIG_MATRIX must be bit-close to CLASSIC."""

import numpy as np
import pytest

import gemmul8_tpu as g8
from gemmul8_tpu.bench.evalref import dd_gemm_f64
from gemmul8_tpu.bench.matrices import phi_matrix, relerr_stats

STRATS = [g8.ComputeType.COMPLEX_BIG_MATRIX_ENCODE,
          g8.ComputeType.COMPLEX_CLASSIC_MULT,
          g8.ComputeType.COMPLEX_KARATSUBA_MULT]


def _cplx(m, n, phi, seed, dtype=np.complex128):
    re = phi_matrix(m, n, phi, seed)
    im = phi_matrix(m, n, phi, seed + 1)
    return (re + 1j * im).astype(dtype)


def _ref(a, b):
    re = dd_gemm_f64(a.real, b.real) - dd_gemm_f64(a.imag, b.imag)
    im = dd_gemm_f64(a.real, b.imag) + dd_gemm_f64(a.imag, b.real)
    return re + 1j * im


@pytest.mark.parametrize("strat", STRATS)
@pytest.mark.parametrize("fastmode", [True, False])
def test_complex128_strategies(strat, fastmode):
    a = _cplx(16, 128, 0.5, seed=60)
    b = _cplx(128, 16, 0.5, seed=70)
    ref = _ref(a, b)
    c = np.asarray(g8.gemm(a, b, num_moduli=14, fastmode=fastmode,
                           compute_type=strat))
    assert c.dtype == np.complex128
    err = np.abs(c - ref) / np.maximum(np.abs(ref), 1e-300)
    assert err.max() < 1e-9, (strat, fastmode, err.max())


@pytest.mark.parametrize("strat", STRATS)
def test_complex64(strat):
    a = _cplx(16, 128, 0.5, seed=80, dtype=np.complex64)
    b = _cplx(128, 16, 0.5, seed=90, dtype=np.complex64)
    ref = _ref(a.astype(np.complex128), b.astype(np.complex128))
    c = np.asarray(g8.gemm(a, b, num_moduli=8, compute_type=strat))
    assert c.dtype == np.complex64
    err = np.abs(c.astype(np.complex128) - ref) / np.abs(ref)
    assert np.median(err) < 5e-7, (strat, np.median(err))


def test_complex_alpha_beta():
    a = _cplx(8, 64, 0.5, seed=100)
    b = _cplx(64, 8, 0.5, seed=101)
    c0 = _cplx(8, 8, 0.5, seed=102)
    alpha, beta = (1.5 - 0.5j), (0.25 + 2.0j)
    got = np.asarray(g8.gemm(a, b, alpha=alpha, beta=beta, c=c0,
                             num_moduli=16,
                             compute_type=g8.ComputeType.COMPLEX_KARATSUBA_MULT))
    ref = alpha * _ref(a, b) + beta * c0
    err = np.abs(got - ref) / np.abs(ref)
    assert err.max() < 1e-13, err.max()


def test_complex_exact_at_20():
    """20 moduli + tiny k: strategies are exact, so all three agree
    bit-for-bit."""
    a = _cplx(6, 12, 1.0, seed=110)
    b = _cplx(12, 6, 1.0, seed=111)
    outs = [np.asarray(g8.gemm(a, b, num_moduli=20, compute_type=s))
            for s in STRATS]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


@pytest.mark.parametrize("strat", STRATS)
def test_mixed_complex_types(strat):
    """complex128 x complex64 (the reference's 4 mixed complex
    specializations, gemmul8.hpp:18-287) — widest-type output."""
    rng = np.random.default_rng(2)
    z1 = (rng.random((24, 40)) - .5) + 1j * (rng.random((24, 40)) - .5)
    z2 = ((rng.random((40, 16)) - .5)
          + 1j * (rng.random((40, 16)) - .5)).astype(np.complex64)
    c = np.asarray(g8.gemm(z1, z2, num_moduli=14, compute_type=strat))
    ref = z1 @ z2.astype(np.complex128)
    assert c.dtype == np.complex128
    assert float(np.abs((c - ref) / np.abs(ref)).max()) < 1e-12
    # and the transposed-op route
    c2 = np.asarray(g8.gemm(z1.T.copy(), z2, num_moduli=14,
                            compute_type=strat, op_a="T"))
    assert np.abs((c2 - ref) / np.abs(ref)).max() < 1e-12


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_complex_configs(seed):
    """Random complex shapes / strategies / moduli / modes vs numpy
    complex128 reference."""
    rng = np.random.default_rng(500 + seed)
    m = int(rng.integers(3, 40))
    k = int(rng.integers(3, 120))
    n = int(rng.integers(3, 40))
    L = int(rng.integers(12, 21))
    fast = bool(rng.integers(0, 2))
    strat = STRATS[int(rng.integers(0, 3))]
    z1 = (phi_matrix(m, k, 1.0, 600 + seed)
          + 1j * phi_matrix(m, k, 1.0, 700 + seed))
    z2 = (phi_matrix(k, n, 1.0, 800 + seed)
          + 1j * phi_matrix(k, n, 1.0, 900 + seed))
    c = np.asarray(g8.gemm(z1, z2, num_moduli=L, fastmode=fast,
                           compute_type=strat))
    ref = z1 @ z2
    med = float(np.median(np.abs(c - ref) / np.abs(ref)))
    assert med < 1e-8, (m, k, n, L, fast, strat, med)


def test_accurate_complex_magnitude_overflow_regression():
    """Regression: accurate-mode complex with maximal-mantissa Re == Im used
    to wrap the |Re|+|Im| int8 magnitude (64+64 = 128 -> -128), silently
    corrupting the shift selection (~46x wrong results)."""
    v = float.fromhex("0x1.fffffffffffffp0")
    A = np.full((1, 64), v + v * 1j)
    B = np.full((64, 1), v + 0j)
    for strat in STRATS:
        c = np.asarray(g8.gemm(A, B, num_moduli=14, fastmode=False,
                               compute_type=strat))
        ref = (A @ B)[0, 0]
        assert abs(c[0, 0] - ref) / abs(ref) < 1e-12, (strat, c[0, 0], ref)
