"""Every public path lowers for the GPU (jax.export for platforms=["cuda"],
in-process, no card needed) and holds no TPU custom call or Mosaic op.

A CPU run cannot ask the GPU compiler anything, but a path that does not
even lower for CUDA fails here instead of on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gemmul8_tpu as g8
from gemmul8_tpu import api
from gemmul8_tpu.parallel import distributed as dist
from gemmul8_tpu.types import ComputeType, F64Bits

M, K, N = 48, 96, 32
CT = ComputeType


def _spec(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _export(fn, *specs):
    exp = jax.export.export(jax.jit(fn), platforms=["cuda"])(*specs)
    text = exp.mlir_module()
    assert exp.platforms == ("cuda",)
    assert "tpu_custom_call" not in text
    assert "mosaic" not in text.lower()
    assert "stablehlo.dot_general" in text
    return text


F64, F32 = jnp.float64, jnp.float32
C128, C64 = jnp.complex128, jnp.complex64

REAL = {
    "f64-fast": (dict(num_moduli=14), F64, F64),
    "f64-accurate": (dict(num_moduli=14, fastmode=False), F64, F64),
    "f32-fast": (dict(num_moduli=8), F32, F32),
    "md": (dict(num_moduli=12, out_dtype=np.float64), F64, F32),
    "mf": (dict(num_moduli=12, out_dtype=np.float32), F64, F32),
    "chunked": (dict(num_moduli=14, moduli_chunk=4), F64, F64),
    "panel": (dict(num_moduli=14, n_panel=16), F64, F64),
}


@pytest.mark.parametrize("name", sorted(REAL))
def test_real_path_exports_for_cuda(name):
    kw, ta, tb = REAL[name]
    _export(lambda a, b: g8.gemm(a, b, **kw), _spec((M, K), ta),
            _spec((K, N), tb))


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("ct", [CT.COMPLEX_BIG_MATRIX_ENCODE,
                                CT.COMPLEX_CLASSIC_MULT,
                                CT.COMPLEX_KARATSUBA_MULT])
def test_complex_path_exports_for_cuda(ct, fastmode):
    _export(lambda a, b: g8.gemm(a, b, num_moduli=14, fastmode=fastmode,
                                 compute_type=ct),
            _spec((M, K), C128), _spec((K, N), C128))


@pytest.mark.parametrize("dtype", [F64, C64])
def test_batched_exports_for_cuda(dtype):
    _export(lambda a, b: g8.gemm_batched(a, b, num_moduli=10),
            _spec((2, M, K), dtype), _spec((2, K, N), dtype))


def test_alpha_beta_epilogue_exports_for_cuda():
    _export(lambda a, b, c: g8.gemm(a, b, alpha=-1.0, beta=1.0, c=c),
            _spec((M, K), F64), _spec((K, N), F64), _spec((M, N), F64))


def test_bits_operands_export_for_cuda():
    u = _spec((M, K), jnp.uint32)
    v = _spec((K, N), jnp.uint32)
    _export(lambda ah, al, bh, bl: api._jit_core(14, True, "f64")(
        F64Bits(ah, al), F64Bits(bh, bl)), u, u, v, v)


@pytest.mark.parametrize("case", ["fast", "accurate", "complex"])
def test_gemm_sharded_exports_for_cuda(case):
    mesh = dist.make_mesh(4)
    u = _spec((M, K), jnp.uint32)
    v = _spec((K, N), jnp.uint32)
    if case == "complex":
        fn = dist._build_sharded_complex(mesh, 14, "f64", True, True,
                                         CT.COMPLEX_KARATSUBA_MULT)
        a, b = F64Bits(u, u), F64Bits(v, v)
        exp = jax.export.export(fn, platforms=["cuda"])(a, a, b, b)
    else:
        fn = dist._build_sharded(mesh, 14, "f64", True, True,
                                 case == "fast", None)
        exp = jax.export.export(fn, platforms=["cuda"])(F64Bits(u, u),
                                                        F64Bits(v, v))
    text = exp.mlir_module()
    assert exp.nr_devices == 4
    assert "tpu_custom_call" not in text and "mosaic" not in text.lower()
    assert "reduce_scatter" in text
