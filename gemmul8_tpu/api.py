"""Public cuBLAS-style front end.

Parity target: the 12 `gemmul8::gemm<TA,TB,TC>` specializations and
`workSize` of the reference (GEMMul8 include/gemmul8.hpp:18-287),
re-expressed for JAX: C = alpha * op(A) @ op(B) + beta * C with per-call
`num_moduli` (accuracy knob), `fastmode`, and complex computeType.

dtype handling: FP64 operands are native float64 arrays (returned as
float64 when x64 is enabled, see types.backend_has_f64) or F64Bits words
(returned as F64Bits). FP32 operands are plain float32 arrays. Mixed
combinations are free — encode dispatches per operand, CRT reconstruction
rounds to the requested output type.
"""

from __future__ import annotations

from typing import Optional, Union

import functools as _functools

import jax
import jax.numpy as jnp
import numpy as np

from . import tables
from .core import gemm as _g
from .types import (C64Bits, ComputeType, F64Bits, backend_has_f64,
                    bits_to_f64, f64_to_bits)

ArrayLike = Union[F64Bits, jax.Array, np.ndarray]


def _canon_real(x: ArrayLike) -> _g.Operand:
    """Canonicalize a real operand to F64Bits or float32 jax array."""
    if isinstance(x, F64Bits):
        return x
    if isinstance(x, np.ndarray):
        if x.dtype == np.float64:
            return f64_to_bits(x)
        return jnp.asarray(x, jnp.float32)
    if x.dtype == jnp.float64:
        return f64_to_bits(x)
    if x.dtype in (jnp.float32, jnp.bfloat16, jnp.float16):
        return x.astype(jnp.float32)
    raise TypeError(f"unsupported operand dtype {x.dtype}")


def _out_kind(a, b, out_dtype) -> str:
    if out_dtype is not None:
        s = str(out_dtype)
        if "64" in s:
            return "f64"
        if "32" in s:
            return "f32"
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    # default: widest input type (reference default: TC follows the wider)
    return "f64" if (isinstance(a, F64Bits) or isinstance(b, F64Bits)) else "f32"


def _apply_op(x, op: str, is_cplx: bool):
    """BLAS-style operand op: 'N' identity, 'T' transpose, 'C' conjugate
    transpose (complex only — parity with the reference's opA/opB args,
    include/gemmul8.hpp gemm signatures)."""
    if op == "N":
        return x
    if op == "T":
        if isinstance(x, C64Bits):
            return C64Bits(x.re.T, x.im.T)
        return x.T if not isinstance(x, np.ndarray) else x.T.copy()
    if op == "C":
        if not is_cplx:
            return x.T if not isinstance(x, np.ndarray) else x.T.copy()
        if isinstance(x, C64Bits):
            im = F64Bits(x.im.hi ^ jnp.uint32(0x80000000), x.im.lo)
            return C64Bits(x.re.T, F64Bits(im.hi.T, im.lo.T))
        return (np.conj(x).T.copy() if isinstance(x, np.ndarray)
                else jnp.conj(x).T)
    raise ValueError(f"op must be N/T/C, got {op}")


def pow2_exponent(x) -> Optional[int]:
    """Static exponent e if x == 2.0**e exactly (finite, positive, normal
    float), else None. Such an alpha folds into the reconstruct's inverse
    scaling for free (e_extra) instead of running the softfloat epilogue —
    the analog of the reference's alpha-specialized inverse_scaling
    kernels (inverse_scaling.hpp:269-820)."""
    try:
        xf = float(x)
    except (TypeError, ValueError):
        return None
    if not np.isfinite(xf) or xf <= 0.0:
        return None
    m, e = np.frexp(xf)
    if m != 0.5:
        return None
    e = int(e) - 1
    # keep folded exponents inside the int32 e_fix budget (|sft| <= ~2^11)
    return e if -900 <= e <= 900 else None


@_functools.lru_cache(maxsize=None)
def _jit_epi_f64(alpha: float, beta: float):
    """One traced softfloat alpha/beta epilogue (one dispatch; the eager
    chain issued dozens)."""
    from .core import softfloat as sf

    def f(hi, lo, chi=None, clo=None):
        out = F64Bits(hi, lo)
        if alpha != 1.0:
            out = sf.mul(out, sf.const_f64(alpha, hi.shape))
        if beta != 0.0:
            cb = sf.mul(F64Bits(chi, clo), sf.const_f64(beta, hi.shape))
            out = sf.add(out, cb)
        return out.hi, out.lo

    return jax.jit(f)


@_functools.lru_cache(maxsize=None)
def _jit_epi_f32(alpha: float, beta: float):
    def f(out, c=None):
        if alpha != 1.0:
            out = out * jnp.float32(alpha)
        if beta != 0.0:
            out = out + jnp.float32(beta) * c
        return out

    return jax.jit(f)


def _canon_c_f64(c_in) -> F64Bits:
    """c operand -> F64Bits for the softfloat epilogue."""
    if isinstance(c_in, F64Bits):
        return c_in
    if isinstance(c_in, np.ndarray):
        return f64_to_bits(np.asarray(c_in, np.float64))
    if getattr(c_in, "dtype", None) == jnp.float64:
        return f64_to_bits(c_in)
    # narrower c: widening to f64 is exact — on the device where f64
    # arrays exist, on the host otherwise
    if backend_has_f64():
        return f64_to_bits(jnp.asarray(c_in, jnp.float64))
    return f64_to_bits(np.asarray(jax.device_get(c_in), np.float64))


def _finalize(c_raw, out_kind: str, alpha, beta, c_in, want_native_f64: bool):
    if out_kind == "f32":
        out = c_raw
        if alpha != 1.0 or beta != 0.0:
            if beta != 0.0 and c_in is None:
                raise ValueError("beta != 0 requires c")
            fn = _jit_epi_f32(float(alpha), float(beta))
            out = fn(out, jnp.asarray(c_in, jnp.float32)) if beta != 0.0 \
                else fn(out)
        return out
    # f64 target: one jitted softfloat graph (bit-identical to the eager
    # sf.mul/sf.add chain — asserted in tests/test_epilogue.py)
    if alpha != 1.0 or beta != 0.0:
        if beta != 0.0 and c_in is None:
            raise ValueError("beta != 0 requires c")
        fn = _jit_epi_f64(float(alpha), float(beta))
        if beta != 0.0:
            cb = _canon_c_f64(c_in)
            hi, lo = fn(c_raw.hi, c_raw.lo, cb.hi, cb.lo)
        else:
            hi, lo = fn(c_raw.hi, c_raw.lo)
        c_raw = F64Bits(hi, lo)
    if want_native_f64 and backend_has_f64():
        return bits_to_f64(c_raw)
    return c_raw


def gemm(
    a: ArrayLike,
    b: ArrayLike,
    *,
    alpha: float = 1.0,
    beta: float = 0.0,
    c: Optional[ArrayLike] = None,
    num_moduli: int = 14,
    fastmode: bool = True,
    compute_type: ComputeType = ComputeType.REAL_DEFAULT,
    out_dtype=None,
    moduli_chunk: Optional[int] = None,
    max_workspace_bytes: Optional[int] = None,
    n_panel: Optional[int] = None,
    op_a: str = "N",
    op_b: str = "N",
    return_times: bool = False,
):
    """Emulated high-precision GEMM via Ozaki Scheme II on int8 matmuls.

    a: (m, k), b: (k, n). num_moduli in [2, 20] trades accuracy for int8
    GEMM count (DGEMM-grade at ~14-15, beyond-FP64 at 18-20; FP32-grade at
    ~7-8). fastmode=False adds one magnitude GEMM for tighter shifts
    (~1 extra modulus worth of accuracy).

    return_times=True returns (C, [encode, int8_gemms, mod_reduce,
    reconstruct] seconds) like every reference gemm call does
    (include/gemmul8.hpp:24-26). The timed call runs the same phases
    staged, each ended by block_until_ready (the reference's own timing
    serializes phases with cudaDeviceSynchronize the same way)."""
    if not (2 <= num_moduli <= tables.MAX_MODULI):
        raise ValueError(f"num_moduli must be in [2, {tables.MAX_MODULI}]")
    is_cplx = (isinstance(a, C64Bits) or isinstance(b, C64Bits)
               or any(hasattr(x, "dtype") and jnp.issubdtype(
                   getattr(x, "dtype", None), jnp.complexfloating)
                   for x in (a, b)))
    a = _apply_op(a, op_a, is_cplx)
    b = _apply_op(b, op_b, is_cplx)
    if is_cplx:
        if (moduli_chunk is not None or max_workspace_bytes is not None
                or n_panel is not None):
            raise NotImplementedError(
                "moduli_chunk / max_workspace_bytes / n_panel are only "
                "supported on the real path (the reference's low-memory "
                "mode is likewise real-only)")
        from .core import complexgemm as cg

        return cg.gemm_complex(a, b, alpha=alpha, beta=beta, c=c,
                               num_moduli=num_moduli, fastmode=fastmode,
                               compute_type=compute_type, out_dtype=out_dtype)
    want_native_f64 = not isinstance(a, F64Bits) and not isinstance(b, F64Bits)
    ca, cb_ = _canon_real(a), _canon_real(b)
    kind = _out_kind(ca, cb_, out_dtype)
    m, k, n = _g._check_shapes(ca, cb_)
    if n_panel is not None and (moduli_chunk is not None
                                or max_workspace_bytes is not None):
        raise ValueError("n_panel and moduli_chunk/max_workspace_bytes are "
                         "mutually exclusive schedules")
    if moduli_chunk is None and max_workspace_bytes is not None:
        from .planner import plan_schedule

        moduli_chunk = plan_schedule(m, n, k, num_moduli,
                                     max_workspace_bytes).chunk
    if return_times:
        if n_panel is not None or moduli_chunk is not None:
            raise NotImplementedError(
                "return_times is for the one-shot schedule")
        c_raw, times = _timed_core(ca, cb_, num_moduli, fastmode, kind, 1)
        return _finalize(c_raw, kind, alpha, beta, c, want_native_f64), times
    # power-of-two alpha folds into the reconstruct exponent: exact (the
    # result is rounded once at the folded scale) and free
    alpha_e = 0
    if beta == 0.0:
        e = pow2_exponent(alpha)
        if e is not None:
            alpha_e, alpha = e, 1.0
    if n_panel is not None and n_panel < n:
        c_raw = _jit_panels(num_moduli, fastmode, kind, n_panel,
                            alpha_e)(ca, cb_)
    else:
        c_raw = _jit_core(num_moduli, fastmode, kind, moduli_chunk,
                          alpha_e)(ca, cb_)
    return _finalize(c_raw, kind, alpha, beta, c, want_native_f64)


@_functools.lru_cache(maxsize=None)
def _jit_core(num_moduli: int, fastmode: bool, kind: str,
              moduli_chunk=None, alpha_e: int = 0):
    return jax.jit(lambda a, b: _g.gemm_core(a, b, num_moduli, fastmode,
                                             kind, moduli_chunk,
                                             alpha_e=alpha_e))


@_functools.lru_cache(maxsize=None)
def _jit_panels(num_moduli: int, fastmode: bool, kind: str, n_panel: int,
                alpha_e: int = 0):
    return jax.jit(lambda a, b: _g.gemm_core_panels(
        a, b, num_moduli, fastmode, kind, n_panel, alpha_e=alpha_e))


def gemm_batched(a, b, *, num_moduli: int = 14, fastmode: bool = True,
                 out_dtype=None,
                 compute_type: ComputeType = ComputeType.REAL_DEFAULT):
    """Strided-batch emulated GEMM: a (B, m, k) x b (B, k, n) -> (B, m, n).
    Capability parity with cuMpSGEMM's gemm_stridedBatch — including the
    complex variant (gemm_stridedBatch<cuComplex>,
    include/cumpsgemm/cumpsgemm.hpp:27): complex64/128 batches route
    through the complex engine with the chosen compute_type."""
    is_cplx = (isinstance(a, C64Bits) or isinstance(b, C64Bits)
               or any(hasattr(x, "dtype") and jnp.issubdtype(
                   getattr(x, "dtype", None), jnp.complexfloating)
                   for x in (a, b)))
    if is_cplx:
        return _gemm_batched_complex(a, b, num_moduli, fastmode, out_dtype,
                                     compute_type)
    ca, cb_ = _canon_real(a), _canon_real(b)
    if len(ca.shape) != 3 or len(cb_.shape) != 3:
        raise ValueError("gemm_batched expects 3D (batch, rows, cols)")
    if ca.shape[0] != cb_.shape[0] or ca.shape[2] != cb_.shape[1]:
        raise ValueError(f"batch shapes mismatch: {ca.shape} x {cb_.shape}")
    if ca.shape[2] > tables.MAX_K:
        raise ValueError("k exceeds the int32-exactness bound 2^17")
    kind = _out_kind(ca, cb_, out_dtype)
    fn = _jit_batched(num_moduli, fastmode, kind)
    out = fn(ca, cb_)
    if (kind == "f64" and backend_has_f64()
            and not isinstance(a, F64Bits) and not isinstance(b, F64Bits)):
        return bits_to_f64(out)
    return out


def _gemm_batched_complex(a, b, num_moduli, fastmode, out_dtype,
                          compute_type):
    from .core import complexgemm as cg

    a_re, a_im, kind_a = cg._canon_complex(a)
    b_re, b_im, kind_b = cg._canon_complex(b)
    if len(a_re.shape) != 3 or len(b_re.shape) != 3:
        raise ValueError("gemm_batched expects 3D (batch, rows, cols)")
    if (a_re.shape[0] != b_re.shape[0]
            or a_re.shape[2] != b_re.shape[1]):
        raise ValueError(
            f"batch shapes mismatch: {a_re.shape} x {b_re.shape}")
    if out_dtype is not None:
        out_c128 = "128" in str(out_dtype)
    else:
        out_c128 = "c128" in (kind_a, kind_b)
    kind = "f64" if out_c128 else "f32"
    ore, oim = _jit_batched_complex(num_moduli, fastmode, compute_type,
                                    kind)(a_re, a_im, b_re, b_im)
    if kind == "f32":
        return jax.lax.complex(ore, oim)
    if backend_has_f64() and not any(
            isinstance(x, (C64Bits, F64Bits)) for x in (a, b)):
        return jax.lax.complex(bits_to_f64(ore), bits_to_f64(oim))
    return C64Bits(ore, oim)


@_functools.lru_cache(maxsize=None)
def _jit_batched_complex(num_moduli: int, fastmode: bool,
                         compute_type: ComputeType, kind: str):
    from .core import complexgemm as cg

    return jax.jit(jax.vmap(lambda ar, ai, br, bi: cg.gemm_complex_core(
        ar, ai, br, bi, num_moduli, fastmode, compute_type, kind)))


@_functools.lru_cache(maxsize=None)
def _jit_batched(num_moduli: int, fastmode: bool, kind: str):
    return jax.jit(jax.vmap(lambda x, y: _g.gemm_core(
        x, y, num_moduli, fastmode, kind)))


def gemm_timed(a, b, *, num_moduli: int = 14, fastmode: bool = True,
               out_dtype=None, iters: int = 1):
    """Run gemm with the reference's 4-phase staged timing breakdown.

    Returns (C, times) where times = [encode, int8_gemms, mod_reduce,
    reconstruct] seconds (cf. include/gemmul8.hpp:24-26)."""
    ca, cb_ = _canon_real(a), _canon_real(b)
    kind = _out_kind(ca, cb_, out_dtype)
    out, times = _timed_core(ca, cb_, num_moduli, fastmode, kind, iters)
    if (kind == "f64" and backend_has_f64()
            and not isinstance(a, F64Bits) and not isinstance(b, F64Bits)):
        out = bits_to_f64(out)
    return out, times


def _timed_core(ca, cb_, num_moduli: int, fastmode: bool, kind: str,
                iters: int):
    """Staged run of the four phases the fused path composes (gemm_phases).
    Returns (raw out, 4-phase seconds).

    Semantics parity note: the reference serializes its phases with
    cudaDeviceSynchronize to time them (gemmul8.cu:10-18); this ends each
    phase with block_until_ready the same way, so a timed call writes phase
    boundaries to memory that the fused call keeps in its fusions."""
    import time

    p_enc, p_mm, p_mod, p_rec = _g.gemm_phases(ca, cb_, num_moduli, fastmode,
                                               kind)

    def timed(fn, *args):
        out = jax.block_until_ready(fn(*args))   # compile + warm up
        t0 = time.perf_counter()
        for _ in range(iters):
            out = jax.block_until_ready(fn(*args))
        return out, (time.perf_counter() - t0) / iters

    (a8, sft_a, b8, sft_b), t_enc = timed(p_enc, ca, cb_)
    c32, t_mm = timed(p_mm, a8, b8)
    r, t_mod = timed(p_mod, c32)
    out, t_rec = timed(p_rec, r, sft_a, sft_b)
    return out, [t_enc, t_mm, t_mod, t_rec]


def workspace_bytes(m: int, n: int, k: int, num_moduli: int,
                    compute_type: ComputeType = ComputeType.REAL_DEFAULT) -> int:
    """Peak auxiliary-buffer estimate, parity with gemmul8::workSize
    (gemmul8.cu:27-147). JAX allocates internally; this reports the planner's
    expectation for capacity planning / the low-memory mode decision."""
    from .planner import workspace_bytes as _wb

    return _wb(m, n, k, num_moduli, compute_type)
