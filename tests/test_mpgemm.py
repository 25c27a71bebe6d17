"""Mutable-precision (bf16 split-and-correct) SGEMM modes."""

import numpy as np
import pytest

import jax.numpy as jnp

from gemmul8_tpu.ops import mpgemm
from gemmul8_tpu.bench.matrices import phi_matrix, relerr_stats


@pytest.fixture(scope="module")
def data():
    a = phi_matrix(64, 256, 0.5, seed=600).astype(np.float32)
    b = phi_matrix(256, 64, 0.5, seed=601).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    return jnp.asarray(a), jnp.asarray(b), ref


def test_mode_accuracy_ladder(data):
    a, b, ref = data
    errs = {}
    for mode in [mpgemm.Mode.BF16TC, mpgemm.Mode.BF16X3, mpgemm.Mode.BF16X6,
                 mpgemm.Mode.NATIVE, mpgemm.Mode.SCALING]:
        c = np.asarray(mpgemm.mp_gemm(a, b, mode)).astype(np.float64)
        errs[mode] = relerr_stats(c, ref)[1]
    assert errs[mpgemm.Mode.BF16X3] < errs[mpgemm.Mode.BF16TC] / 10
    assert errs[mpgemm.Mode.BF16X6] < errs[mpgemm.Mode.BF16X3]
    assert errs[mpgemm.Mode.BF16TC] > 1e-4       # plain bf16 is coarse
    assert errs[mpgemm.Mode.BF16X3] < 5e-6       # corrected
    assert errs[mpgemm.Mode.NATIVE] < 5e-7
    assert errs[mpgemm.Mode.SCALING] < 5e-6


def test_auto_mode_picks_sane_path(data):
    a, b, ref = data
    c = np.asarray(mpgemm.mp_gemm(a, b, mpgemm.Mode.AUTO)).astype(np.float64)
    assert relerr_stats(c, ref)[1] < 5e-6


def test_exp_stats():
    x = jnp.asarray(np.array([1.0, 2.0 ** -30, 4.0, 0.0], np.float32))
    s = mpgemm.exp_stats(x, lose_threshold=16)
    assert int(s.max_exp) == 127 + 2
    assert int(s.total) == 3
    assert abs(float(s.lost_fraction) - 1 / 3) < 1e-6


def test_cgemm(data):
    a, b, ref = data
    an, bn = np.asarray(a), np.asarray(b)
    az = (an + 1j * (an * 0.7 + 0.1)).astype(np.complex64)
    bz = (bn + 0.5j * bn).astype(np.complex64)
    c = np.asarray(mpgemm.mp_cgemm(jnp.asarray(az), jnp.asarray(bz)))
    refz = az.astype(np.complex128) @ bz.astype(np.complex128)
    err = np.abs(c.astype(np.complex128) - refz) / np.abs(refz)
    assert np.median(err) < 1e-5


def test_gemm_mx2x2_matches_exact():
    """(m, 2) x (2, 2) skinny path (cuGEMM-Mx2x2 analog): exact f32
    mult-adds, plain / batched / complex, and the enable/disable toggle."""
    rng = np.random.default_rng(7)
    a = rng.standard_normal((257, 2)).astype(np.float32)
    b = rng.standard_normal((2, 2)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(mpgemm.mp_gemm(a, b, mpgemm.Mode.BF16TC))
    # rerouted -> exact-to-f32, far tighter than bf16 would be
    assert np.abs(got - want).max() < 1e-5
    assert np.array_equal(got, np.asarray(mpgemm.gemm_Mx2x2(a, b)))
    # strided batch via leading dims
    ab = rng.standard_normal((3, 65, 2)).astype(np.float32)
    bb = rng.standard_normal((3, 2, 2)).astype(np.float32)
    gotb = np.asarray(mpgemm.gemm_Mx2x2(ab, bb))
    for i in range(3):
        assert np.allclose(gotb[i], ab[i] @ bb[i], atol=1e-6)
    # complex via mp_cgemm's 4 real products
    az = (a + 0.3j * a).astype(np.complex64)
    bz = (b - 0.7j * b).astype(np.complex64)
    gz = np.asarray(mpgemm.mp_cgemm(az, bz, mpgemm.Mode.BF16TC))
    assert np.abs(gz - az.astype(np.complex128) @ bz).max() < 1e-4
    # toggle off -> the bf16 path runs and is visibly coarser
    mpgemm.disable_custom_gemm_Mx2x2()
    try:
        coarse = np.asarray(mpgemm.mp_gemm(a, b, mpgemm.Mode.BF16TC))
        assert np.abs(coarse - want).max() > 1e-5
    finally:
        mpgemm.enable_custom_gemm_Mx2x2()


def test_hijack_control_load_probe():
    import jax.numpy as jnp2
    from gemmul8_tpu import interception as icp

    assert not icp.is_library_loaded()
    with icp.override_matmuls(num_moduli=8):
        assert icp.is_library_loaded()
    assert not icp.is_library_loaded()
    # parity no-ops must exist and accept calls
    icp.enable_restoring_AB_after_scaling()
    icp.disable_restoring_AB_after_scaling()
