"""Regression tests for review findings: interception eligibility and the
@ operator, profile fencing, op_a='T' on complex bit operands, scaling-mode
zero rows, exp2 unscale overflow, ozimmu k bound, and the epilogue's
non-f64 c handling."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import gemmul8_tpu as g8
from gemmul8_tpu import interception as icp
from gemmul8_tpu.ops import mpgemm


def test_intercept_requires_both_dtypes_eligible():
    a = jnp.ones((128, 128), jnp.float32)
    b = jnp.ones((128, 128), jnp.int32)
    with icp.override_matmuls():
        out = jnp.matmul(a, b)  # must pass through, not crash in gemm
    assert out.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out), 128.0)


def test_matmul_operator_is_intercepted():
    a = jnp.asarray(np.random.default_rng(0).standard_normal((128, 128)),
                    jnp.float32)
    icp.clear_profile_log()
    with icp.override_matmuls(num_moduli=8, profile=True):
        out_op = a @ a
        out_fn = jnp.matmul(a, a)
    log = icp.get_profile_log()
    assert len(log) == 2, f"@ operator not routed: {log}"
    assert all(r.mode.startswith("emulate") for r in log)
    np.testing.assert_array_equal(np.asarray(out_op), np.asarray(out_fn))
    # and the patch is fully undone outside the context
    ref = np.asarray(a) @ np.asarray(a)
    np.testing.assert_allclose(np.asarray(a @ a), ref, rtol=1e-5)


def test_matmul_operator_intercepted_under_jit():
    a = jnp.asarray(np.random.default_rng(1).standard_normal((128, 128)),
                    jnp.float32)
    with icp.override_matmuls(num_moduli=10):
        emulated = jax.jit(lambda x: x @ x)(a)
    # bit-equality with the emulator is the only non-vacuous check (native
    # f32 matmul is itself ~1e-7 accurate at this size)
    expected = np.asarray(g8.gemm(a, a, num_moduli=10))
    np.testing.assert_array_equal(np.asarray(emulated), expected)


def test_profile_logs_native_calls_too():
    a = jnp.ones((8, 8), jnp.float32)  # below intercept threshold
    icp.clear_profile_log()
    with icp.override_matmuls(profile=True):
        jnp.matmul(a, a)
    log = icp.get_profile_log()
    assert len(log) == 1 and log[0].mode == "native"


def test_complex_bits_transpose_op():
    """op_a='T' on the bits complex128 representation (C64Bits)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 32)) + 1j * rng.standard_normal((16, 32))
    b = rng.standard_normal((16, 24)) + 1j * rng.standard_normal((16, 24))
    from gemmul8_tpu.types import C64Bits, bits_to_f64, f64_to_bits

    a_bits = C64Bits(f64_to_bits(a.real.copy()), f64_to_bits(a.imag.copy()))
    ref = np.asarray(g8.gemm(a.T.copy(), b, num_moduli=14))
    got_bits = g8.gemm(a_bits, b, num_moduli=14, op_a="T")
    got = (np.asarray(bits_to_f64(got_bits.re, to_numpy=True))
           + 1j * np.asarray(bits_to_f64(got_bits.im, to_numpy=True)))
    np.testing.assert_array_equal(got, ref)


def test_scaling_mode_zero_rows_no_nan():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 32)).astype(np.float32)
    a[5] = 0.0      # all-zero row (e.g. padding)
    b[:, 7] = 0.0   # all-zero column
    out = np.asarray(mpgemm.mp_gemm(a, b, mpgemm.Mode.SCALING))
    assert np.isfinite(out).all(), "zero rows produced NaN/inf"
    np.testing.assert_array_equal(out[5], 0.0)
    np.testing.assert_array_equal(out[:, 7], 0.0)


def test_scaling_mode_extreme_magnitudes():
    """exp2(ea + eb) would overflow at combined exponents > 127 even when
    the true product is representable (here: 2^100 * 2^-90 entries)."""
    a = np.full((8, 16), 2.0 ** 100, np.float32)
    b = np.full((16, 8), 2.0 ** -90, np.float32)
    out = np.asarray(mpgemm.mp_gemm(a, b, mpgemm.Mode.SCALING))
    np.testing.assert_allclose(out, 16 * 2.0 ** 10, rtol=1e-3)


def test_ozimmu_k_bound_enforced():
    from gemmul8_tpu.baselines.ozimmu import ozimmu_gemm
    from gemmul8_tpu.types import f64_to_bits

    a = f64_to_bits(np.zeros((2, (1 << 17) + 128)))
    b = f64_to_bits(np.zeros(((1 << 17) + 128, 2)))
    with pytest.raises(ValueError, match="2\\^17"):
        ozimmu_gemm(a, b, num_split=4)


def test_epilogue_with_f32_jax_c():
    """beta path with a non-f64 jax-array c must widen exactly, not
    misinterpret bit words."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((16, 64))
    b = rng.standard_normal((64, 16))
    c32 = jnp.asarray(rng.standard_normal((16, 16)).astype(np.float32))
    got = np.asarray(g8.gemm(a, b, beta=1.0, c=c32, num_moduli=14))
    prod = np.asarray(g8.gemm(a, b, num_moduli=14))
    ref = prod + np.asarray(c32, np.float64)
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    assert err.max() < 4e-16


def test_batched_native_gate_symmetric():
    """gemm_batched(a_np, b_bits) must follow the same bits-domain contract
    as gemm(): F64Bits out when either operand is F64Bits."""
    from gemmul8_tpu.types import F64Bits, f64_to_bits

    rng = np.random.default_rng(6)
    a = rng.standard_normal((2, 8, 32))
    b = rng.standard_normal((2, 32, 8))
    out = g8.gemm_batched(a, f64_to_bits(b), num_moduli=10)
    assert isinstance(out, F64Bits)
    out2, _ = g8.gemm_timed(a[0], f64_to_bits(b[0]), num_moduli=10)
    assert isinstance(out2, F64Bits)


def test_complex_lowmem_params_raise():
    z = np.ones((8, 16)) + 1j
    with pytest.raises(NotImplementedError):
        g8.gemm(z, z.T.copy(), num_moduli=6, moduli_chunk=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        g8.gemm(np.ones((8, 16)), np.ones((16, 8)), num_moduli=6,
                n_panel=4, moduli_chunk=2)


def test_as_numpy_f64bits_roundtrip():
    from gemmul8_tpu.types import as_numpy, f64_to_bits

    x = np.random.default_rng(8).standard_normal((4, 4))
    out = as_numpy(f64_to_bits(x))
    assert out.dtype == np.float64 and out.shape == (4, 4)
    np.testing.assert_array_equal(out, x)
    np.testing.assert_array_equal(as_numpy(x.astype(np.float32)),
                                  x.astype(np.float32))


def test_config_env_validation(monkeypatch):
    from gemmul8_tpu import config as cfg

    try:
        monkeypatch.setenv("GEMMUL8_COMPUTE_MODE", "natve")  # typo
        with pytest.raises(ValueError, match="COMPUTE_MODE"):
            cfg.reload_config()
        monkeypatch.setenv("GEMMUL8_COMPUTE_MODE", "native")
        monkeypatch.setenv("GEMMUL8_FASTMODE", "FALSE")
        c = cfg.reload_config()
        assert c.compute_mode == "native" and c.fastmode is False
        monkeypatch.setenv("GEMMUL8_FASTMODE", "maybe")
        with pytest.raises(ValueError, match="FASTMODE"):
            cfg.reload_config()
    finally:
        monkeypatch.delenv("GEMMUL8_COMPUTE_MODE", raising=False)
        monkeypatch.delenv("GEMMUL8_FASTMODE", raising=False)
        cfg.reload_config()


def test_f64bits_real_operand_in_complex_gemm():
    """A real F64Bits operand mixed with a complex operand (crashed in
    _canon_complex before)."""
    from gemmul8_tpu.types import f64_to_bits

    rng = np.random.default_rng(9)
    a = rng.standard_normal((8, 32))
    b = rng.standard_normal((32, 8)) + 1j * rng.standard_normal((32, 8))
    ref = np.asarray(g8.gemm(a, b, num_moduli=14))
    got = g8.gemm(f64_to_bits(a), b, num_moduli=14)
    from gemmul8_tpu.types import bits_to_f64

    gotc = (bits_to_f64(got.re, to_numpy=True)
            + 1j * bits_to_f64(got.im, to_numpy=True))
    np.testing.assert_array_equal(gotc, ref)


def test_complex128_beta_with_complex64_c():
    """c128 epilogue with a narrow (complex64) c must widen, not crash."""
    rng = np.random.default_rng(10)
    a = rng.standard_normal((8, 32)) + 1j * rng.standard_normal((8, 32))
    b = rng.standard_normal((32, 8)) + 1j * rng.standard_normal((32, 8))
    c64 = (rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
           ).astype(np.complex64)
    prod = np.asarray(g8.gemm(a, b, num_moduli=14))
    got = np.asarray(g8.gemm(a, b, beta=0.5, c=c64, num_moduli=14))
    ref = prod + 0.5 * c64.astype(np.complex128)
    err = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    assert err.max() < 1e-15
    # alpha=1.0 with beta!=0 must not perturb the product term at all
    got2 = np.asarray(g8.gemm(a, b, alpha=1.0, beta=0.5, c=c64,
                              num_moduli=14))
    np.testing.assert_array_equal(got2, got)


def test_planner_complex_strategies_ordering():
    """The classic/kara estimates must exceed the real path (they hold
    more simultaneously-live product/slice batches), and the low-memory
    chunk must respect the budget with the 8-byte product+residue term."""
    from gemmul8_tpu import planner
    from gemmul8_tpu.types import ComputeType as CT

    m = n = k = 2048
    real = planner.workspace_bytes(m, n, k, 14, CT.REAL_DEFAULT)
    classic = planner.workspace_bytes(m, n, k, 14, CT.COMPLEX_CLASSIC_MULT)
    kara = planner.workspace_bytes(m, n, k, 14, CT.COMPLEX_KARATSUBA_MULT)
    big = planner.workspace_bytes(m, n, k, 14, CT.COMPLEX_BIG_MATRIX_ENCODE)
    assert classic > 2 * real and kara > 2 * real and big > 2 * real
    # classic: 4 live (L,m,n) int32 product batches must be covered
    assert classic >= 4 * 14 * m * n * 4
    sched = planner.plan_schedule(m, n, k, 14, budget_bytes=500 * 2 ** 20)
    per_mod = (m * k + k * n) + m * n * 8
    assert sched.chunk * per_mod <= 500 * 2 ** 20
