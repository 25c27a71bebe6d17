"""Mesh-sharded emulated GEMM on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

import gemmul8_tpu as g8
from gemmul8_tpu.bench.matrices import phi_matrix, relerr_stats
from gemmul8_tpu.parallel import distributed as dist
from gemmul8_tpu.types import F64Bits, bits_to_f64, f64_to_bits


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return dist.make_mesh(8, shape=(2, 4))


def test_sharded_f64_matches_single(mesh):
    m, k, n = 32, 256, 64
    a = phi_matrix(m, k, 0.5, seed=200)
    b = phi_matrix(k, n, 0.5, seed=201)
    out = dist.gemm_sharded(f64_to_bits(a), f64_to_bits(b), mesh,
                            num_moduli=14)
    got = bits_to_f64(out, to_numpy=True)
    single = np.asarray(g8.gemm(a, b, num_moduli=14))
    ref = a @ b
    # sharded and single-chip may pick shifts differing by 1 ulp of the
    # norm statistic; both must sit at the same accuracy level
    assert relerr_stats(got, ref)[0] < 1e-10
    assert relerr_stats(single, ref)[0] < 1e-10
    assert out.hi.sharding.spec == jax.sharding.PartitionSpec("x", "y")


def test_sharded_f32(mesh):
    m, k, n = 16, 128, 32
    a = phi_matrix(m, k, 0.5, seed=210).astype(np.float32)
    b = phi_matrix(k, n, 0.5, seed=211).astype(np.float32)
    out = np.asarray(dist.gemm_sharded(a, b, mesh, num_moduli=8))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert relerr_stats(out, ref)[1] < 2e-7


def test_sharded_shape_validation(mesh):
    a = np.zeros((30, 256), np.float32)   # 30 not divisible by x=2? it is;
    b = np.zeros((256, 30), np.float32)   # 30 % 4 != 0 -> error
    with pytest.raises(ValueError, match="divide mesh"):
        dist.gemm_sharded(a, b, mesh, num_moduli=4)


def test_sharded_accurate_mode(mesh):
    """Accurate ('int8tc') sharded: magnitude GEMM psum'd over k-shards;
    result matches the single-device accurate path bit-for-bit (the shift
    selection reductions are all maxes — order-independent)."""
    from gemmul8_tpu.core import gemm as gg

    m, k, n = 16, 128, 32
    a = phi_matrix(m, k, 1.0, seed=300)
    b = phi_matrix(k, n, 1.0, seed=301)
    A, B = f64_to_bits(a), f64_to_bits(b)
    out = dist.gemm_sharded(A, B, mesh, num_moduli=14, fastmode=False)
    single = gg.gemm_core(A, B, 14, False, "f64")
    assert np.array_equal(np.asarray(single.hi), np.asarray(out.hi))
    assert np.array_equal(np.asarray(single.lo), np.asarray(out.lo))


def test_sharded_n_panel_bitexact(mesh):
    m, k, n = 16, 128, 32
    a = phi_matrix(m, k, 0.5, seed=302)
    b = phi_matrix(k, n, 0.5, seed=303)
    A, B = f64_to_bits(a), f64_to_bits(b)
    one = dist.gemm_sharded(A, B, mesh, num_moduli=10)
    pan = dist.gemm_sharded(A, B, mesh, num_moduli=10, n_panel=8)
    assert np.array_equal(np.asarray(one.hi), np.asarray(pan.hi))
    assert np.array_equal(np.asarray(one.lo), np.asarray(pan.lo))


def test_sharded_complex_bigmatrix(mesh):
    from gemmul8_tpu.bench.native import dd_gemm

    m, k, n = 16, 64, 32
    rng = np.random.default_rng(304)
    a = phi_matrix(m, k, 0.5, seed=305) + 1j * phi_matrix(m, k, 0.5,
                                                          seed=306)
    b = phi_matrix(k, n, 0.5, seed=307) + 1j * phi_matrix(k, n, 0.5,
                                                          seed=308)
    zre, zim = dist.gemm_sharded_complex(a, b, mesh, num_moduli=14)
    got = (bits_to_f64(zre, to_numpy=True)
           + 1j * bits_to_f64(zim, to_numpy=True))
    ref = a @ b
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    assert rel.max() < 1e-9


def test_sharded_complex_all_strategies_match(mesh):
    """Classic and karatsuba shard too (VERDICT r4 item 5) — and in this
    exact engine all three strategies produce BIT-IDENTICAL results (the
    residues of identical integer sums; unlike the reference's FP paths,
    which differ in rounding)."""
    from gemmul8_tpu.types import ComputeType

    m, k, n = 16, 64, 32
    a = phi_matrix(m, k, 0.5, seed=310) + 1j * phi_matrix(m, k, 0.5,
                                                          seed=311)
    b = phi_matrix(k, n, 0.5, seed=312) + 1j * phi_matrix(k, n, 0.5,
                                                          seed=313)
    outs = {}
    for ct in (ComputeType.COMPLEX_BIG_MATRIX_ENCODE,
               ComputeType.COMPLEX_CLASSIC_MULT,
               ComputeType.COMPLEX_KARATSUBA_MULT):
        zre, zim = dist.gemm_sharded_complex(a, b, mesh, num_moduli=12,
                                             compute_type=ct)
        outs[ct] = (np.asarray(zre.hi), np.asarray(zre.lo),
                    np.asarray(zim.hi), np.asarray(zim.lo))
    from gemmul8_tpu.types import F64Bits

    base = outs[ComputeType.COMPLEX_BIG_MATRIX_ENCODE]
    ref = a @ b
    got = (bits_to_f64(F64Bits(base[0], base[1]), to_numpy=True)
           + 1j * bits_to_f64(F64Bits(base[2], base[3]), to_numpy=True))
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    assert rel.max() < 1e-8
    for ct, o in outs.items():
        for x, y in zip(o, base):
            assert np.array_equal(x, y), ct


def test_sharded_complex_mixed_width(mesh):
    """c128 A x c64 B shards via per-operand dispatch (no canonicalize
    raise)."""
    m, k, n = 16, 64, 32
    a = phi_matrix(m, k, 0.5, seed=320) + 1j * phi_matrix(m, k, 0.5,
                                                          seed=321)
    b = (phi_matrix(k, n, 0.5, seed=322)
         + 1j * phi_matrix(k, n, 0.5, seed=323)).astype(np.complex64)
    zre, zim = dist.gemm_sharded_complex(a, b, mesh, num_moduli=10)
    got = (bits_to_f64(zre, to_numpy=True)
           + 1j * bits_to_f64(zim, to_numpy=True))
    ref = a @ b.astype(np.complex128)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)
    assert np.median(rel) < 1e-6
