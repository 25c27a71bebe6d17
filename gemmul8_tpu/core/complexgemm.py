"""Complex GEMM emulation: three strategies over the real residue engine.

Parity with the reference's computeType_t algorithms
(/root/reference/GEMMul8/src/gemmul8.cu:579-1052):

- BIG_MATRIX_ENCODE: encode W as the real block matrix [[Re,-Im],[Im,Re]]
  (A side) resp. [[Re],[Im]] (B side) -> ONE int8 GEMM per modulus at
  doubled sizes (gemmul8.cu:579-723). We never materialize the block
  matrix in floats: Re/Im are encoded once with a shared per-row/col shift
  and the int8 slices are assembled blockwise (negation of a centered
  residue is exact in int8, incl. the -128 wraparound for modulus 256).
- CLASSIC_MULT: 4 int8 GEMMs per modulus, Re=RR-II, Im=RI+IR combined in
  int32 residue space (gemmul8.cu:892-1052).
- KARATSUBA_MULT: 3 GEMMs per modulus: E=Re*Re', F=Im*Im',
  G=(Re+Im)(Re'+Im'); Re=E-F, Im=G-E-F; the (Re+Im) operand slices are
  int8 adds re-centered mod m (gemmul8.cu:725-890, mat_utils.hpp:30-83).
  Unlike the reference (alpha=1,beta=0 only, inverse_scaling.hpp:1025-1062)
  all strategies here support the full epilogue.

Key invariant: Re and Im of one row/col share a single shift exponent
(block products mix them), chosen from the joint norm, so every
reconstructed value is |.| <= ||z_row|| * ||z_col|| <= (M-1)/2.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables
from ..types import (C64Bits, ComputeType, F64Bits, backend_has_f64,
                     bits_to_f64, f64_to_bits)
from . import encode as enc
from . import reconstruct as rec
from . import slicegemm as sg

_I32 = jnp.int32

# int32-exactness bounds on k per strategy (|sum| < 2^31):
# big-matrix contracts over 2k; classic sums two k-products; karatsuba
# combines three.
_KMAX = {
    ComputeType.COMPLEX_BIG_MATRIX_ENCODE: tables.MAX_K // 2,
    ComputeType.COMPLEX_CLASSIC_MULT: tables.MAX_K // 2,
    ComputeType.COMPLEX_KARATSUBA_MULT: tables.MAX_K // 4,
}


def _recenter_add_int8(x8: jax.Array, y8: jax.Array, num_moduli: int):
    """Residue-space add with re-centering: (x + y) mod m in [-128, 127].
    The reference's add_int8_mat (mat_utils.hpp:30-83)."""
    t = x8.astype(_I32) + y8.astype(_I32)  # (L, ...) in [-255, 255]
    outs = []
    for j in range(num_moduli):
        m = int(tables.MODULI[j])
        tj = t[j]
        if m == 256:
            outs.append(tj.astype(jnp.int8))
            continue
        half = (m - 1) // 2
        tj = tj - jnp.where(tj > half, _I32(m), _I32(0))
        tj = tj + jnp.where(tj < -half, _I32(m), _I32(0))
        outs.append(tj.astype(jnp.int8))
    return jnp.stack(outs, axis=0)


def _accurate_sfts(a_re, a_im, b_re, b_im, num_moduli: int):
    mag_a, emax_a = enc.mag7_complex(a_re, a_im, axis=1)
    mag_b, emax_b = enc.mag7_complex(b_re, b_im, axis=0)
    s = jax.lax.dot_general(mag_a, mag_b, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    mant_a = 53 if isinstance(a_re, F64Bits) else 24
    mant_b = 53 if isinstance(b_re, F64Bits) else 24
    sft_a = enc.accurate_sft(jnp.max(s, axis=1, keepdims=True), emax_a,
                             num_moduli, mant_a, enc.MAG_SHIFT_COMPLEX)
    sft_b = enc.accurate_sft(jnp.max(s, axis=0, keepdims=True), emax_b,
                             num_moduli, mant_b, enc.MAG_SHIFT_COMPLEX)
    return sft_a, sft_b


def _encode_complex_operands(a_re, a_im, b_re, b_im, num_moduli, fastmode):
    if fastmode:
        a8r, a8i, sft_a = enc.encode_fast_complex(a_re, a_im, num_moduli, 1)
        b8r, b8i, sft_b = enc.encode_fast_complex(b_re, b_im, num_moduli, 0)
    else:
        sft_a, sft_b = _accurate_sfts(a_re, a_im, b_re, b_im, num_moduli)
        a8r, a8i = enc.encode_accurate_complex(a_re, a_im, sft_a, num_moduli)
        b8r, b8i = enc.encode_accurate_complex(b_re, b_im, sft_b, num_moduli)
    return a8r, a8i, sft_a, b8r, b8i, sft_b


def _reconstruct_pair(r_re, r_im, sft_a, sft_b, num_moduli, out_kind,
                      e_extra=0):
    """One reconstruct call over [Re; Im] stacked along rows."""
    r2 = jnp.concatenate([r_re, r_im], axis=1)
    sft_a2 = jnp.concatenate([sft_a, sft_a], axis=0)
    out = rec.reconstruct(r2, sft_a2, sft_b, num_moduli, out_kind, e_extra)
    m = r_re.shape[1]
    return out[:m], out[m:]


def gemm_complex_core(a_re, a_im, b_re, b_im, num_moduli: int,
                      fastmode: bool, compute_type: ComputeType,
                      out_kind: str, e_extra: int = 0):
    """Emulated complex GEMM on canonical (re, im) operand pairs.
    Returns (re, im) in the target real format. e_extra: power-of-two
    (real) alpha exponent folded into the inverse scaling (exact, free)."""
    if compute_type in (ComputeType.REAL_DEFAULT, None):
        compute_type = ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    k = a_re.shape[1]
    if k > _KMAX[compute_type]:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound for {compute_type}")

    a8r, a8i, sft_a, b8r, b8i, sft_b = _encode_complex_operands(
        a_re, a_im, b_re, b_im, num_moduli, fastmode)

    if compute_type == ComputeType.COMPLEX_BIG_MATRIX_ENCODE:
        neg_a8i = (-a8i.astype(_I32)).astype(jnp.int8)
        top = jnp.concatenate([a8r, neg_a8i], axis=2)
        bot = jnp.concatenate([a8i, a8r], axis=2)
        a_blk = jnp.concatenate([top, bot], axis=1)          # (L, 2m, 2k)
        b_blk = jnp.concatenate([b8r, b8i], axis=1)          # (L, 2k, n)
        c32 = sg.slice_products(a_blk, b_blk)                # (L, 2m, n)
        r = sg.mod_reduce(c32, num_moduli)
        sft_a2 = jnp.concatenate([sft_a, sft_a], axis=0)
        out = rec.reconstruct(r, sft_a2, sft_b, num_moduli, out_kind,
                              e_extra)
        m = a_re.shape[0]
        return out[:m], out[m:]

    if compute_type == ComputeType.COMPLEX_CLASSIC_MULT:
        rr = sg.slice_products(a8r, b8r)
        ii = sg.slice_products(a8i, b8i)
        ri = sg.slice_products(a8r, b8i)
        ir = sg.slice_products(a8i, b8r)
        r_re = sg.mod_reduce(rr - ii, num_moduli)
        r_im = sg.mod_reduce(ri + ir, num_moduli)
        return _reconstruct_pair(r_re, r_im, sft_a, sft_b, num_moduli,
                                 out_kind, e_extra)

    if compute_type == ComputeType.COMPLEX_KARATSUBA_MULT:
        s_a = _recenter_add_int8(a8r, a8i, num_moduli)
        s_b = _recenter_add_int8(b8r, b8i, num_moduli)
        e = sg.slice_products(a8r, b8r)
        f = sg.slice_products(a8i, b8i)
        g = sg.slice_products(s_a, s_b)
        r_re = sg.mod_reduce(e - f, num_moduli)
        r_im = sg.mod_reduce(g - e - f, num_moduli)
        return _reconstruct_pair(r_re, r_im, sft_a, sft_b, num_moduli,
                                 out_kind, e_extra)

    raise ValueError(compute_type)


# ---------------------------------------------------------------------------
# Front-end canonicalization.
# ---------------------------------------------------------------------------

def _canon_complex(x):
    """-> (re, im, kind) with re/im canonical Operands."""
    if isinstance(x, C64Bits):
        return x.re, x.im, "c128"
    if isinstance(x, F64Bits):
        # real f64-bits operand mixed into a complex gemm: zero imag
        # (+0.0 is all-zero bits)
        zero = F64Bits(jnp.zeros_like(x.hi), jnp.zeros_like(x.lo))
        return x, zero, "c128"
    if isinstance(x, np.ndarray) and backend_has_f64():
        x = jnp.asarray(x)   # one transfer; the split happens on device
    if isinstance(x, np.ndarray):
        if x.dtype == np.complex128:
            return (f64_to_bits(np.ascontiguousarray(x.real)),
                    f64_to_bits(np.ascontiguousarray(x.imag)), "c128")
        if x.dtype == np.complex64:
            return (jnp.asarray(x.real, jnp.float32),
                    jnp.asarray(x.imag, jnp.float32), "c64")
        # real input to a complex gemm: zero imaginary part
        if x.dtype == np.float64:
            z = np.zeros_like(x)
            return f64_to_bits(x), f64_to_bits(z), "c128"
        return (jnp.asarray(x, jnp.float32),
                jnp.zeros(x.shape, jnp.float32), "c64")
    if x.dtype == jnp.complex128:
        return (f64_to_bits(jnp.real(x)), f64_to_bits(jnp.imag(x)), "c128")
    if x.dtype == jnp.complex64:
        return (jnp.real(x).astype(jnp.float32),
                jnp.imag(x).astype(jnp.float32), "c64")
    if x.dtype == jnp.float64:
        return (f64_to_bits(x), f64_to_bits(jnp.zeros_like(x)), "c128")
    return (x.astype(jnp.float32), jnp.zeros(x.shape, jnp.float32), "c64")


@lru_cache(maxsize=None)
def _jit_complex_core(num_moduli, fastmode, compute_type, out_kind,
                      e_extra=0):
    return jax.jit(lambda ar, ai, br, bi: gemm_complex_core(
        ar, ai, br, bi, num_moduli, fastmode, compute_type, out_kind,
        e_extra))


def _cscale(re, im, z):
    """(re, im) * complex z in softfloat; real z skips the cross
    terms (they would also flip -0.0 imag parts to +0.0)."""
    from . import softfloat as sf

    zr, zi = complex(z).real, complex(z).imag
    shp = re.hi.shape
    if zi == 0.0:
        return (sf.mul(re, sf.const_f64(zr, shp)),
                sf.mul(im, sf.const_f64(zr, shp)))
    return (sf.sub(sf.mul(re, sf.const_f64(zr, shp)),
                   sf.mul(im, sf.const_f64(zi, shp))),
            sf.add(sf.mul(re, sf.const_f64(zi, shp)),
                   sf.mul(im, sf.const_f64(zr, shp))))


@lru_cache(maxsize=None)
def _jit_epi_c128(alpha: complex, beta: complex):
    """One traced softfloat complex alpha/beta epilogue (one dispatch;
    the eager _cscale chain issued dozens)."""
    from . import softfloat as sf

    def f(rh, rl, ih, il, crh=None, crl=None, cih=None, cil=None):
        ore, oim = F64Bits(rh, rl), F64Bits(ih, il)
        if alpha != 1.0:
            ore, oim = _cscale(ore, oim, alpha)
        if beta != 0.0:
            tre, tim = _cscale(F64Bits(crh, crl), F64Bits(cih, cil), beta)
            ore = sf.add(ore, tre)
            oim = sf.add(oim, tim)
        return ore.hi, ore.lo, oim.hi, oim.lo

    return jax.jit(f)


@lru_cache(maxsize=None)
def _jit_epi_c64(alpha: complex, beta: complex):
    def f(ore, oim, cr=None, ci=None):
        ar_, ai_ = alpha.real, alpha.imag
        if alpha != 1.0:
            ore, oim = (ore * jnp.float32(ar_) - oim * jnp.float32(ai_),
                        ore * jnp.float32(ai_) + oim * jnp.float32(ar_))
        if beta != 0.0:
            br_, bi_ = beta.real, beta.imag
            ore = ore + cr * jnp.float32(br_) - ci * jnp.float32(bi_)
            oim = oim + cr * jnp.float32(bi_) + ci * jnp.float32(br_)
        return ore, oim

    return jax.jit(f)


def gemm_complex(a, b, *, alpha=1.0, beta=0.0, c=None, num_moduli=14,
                 fastmode=True, compute_type=ComputeType.REAL_DEFAULT,
                 out_dtype=None):
    a_re, a_im, kind_a = _canon_complex(a)
    b_re, b_im, kind_b = _canon_complex(b)
    if out_dtype is not None:
        s = str(out_dtype)
        out_kind_c = "c128" if "128" in s else "c64"
    else:
        out_kind_c = "c128" if "c128" in (kind_a, kind_b) else "c64"
    out_kind = "f64" if out_kind_c == "c128" else "f32"
    # real power-of-two alpha folds into the inverse scaling (exact, free)
    from ..api import pow2_exponent

    e_extra = 0
    if beta == 0.0 and complex(alpha).imag == 0.0:
        e = pow2_exponent(complex(alpha).real)
        if e is not None:
            e_extra, alpha = e, 1.0
    ore, oim = _jit_complex_core(num_moduli, fastmode, compute_type,
                                 out_kind, e_extra)(a_re, a_im, b_re, b_im)
    if out_kind == "f32":
        if alpha != 1.0 or beta != 0.0:
            if beta != 0.0 and c is None:
                raise ValueError("beta != 0 requires c")
            fn = _jit_epi_c64(complex(alpha), complex(beta))
            if beta != 0.0:
                cn = jnp.asarray(c, jnp.complex64)
                ore, oim = fn(ore, oim, jnp.real(cn), jnp.imag(cn))
            else:
                ore, oim = fn(ore, oim)
        return jax.lax.complex(ore, oim)
    # c128 path: one jitted softfloat graph (bit-identical to the eager
    # chain — asserted in tests/test_complex.py)
    if alpha != 1.0 or beta != 0.0:
        if beta != 0.0 and c is None:
            raise ValueError("beta != 0 requires c")
        fn = _jit_epi_c128(complex(alpha), complex(beta))
        if beta != 0.0:
            c_re, c_im, kind_c = _canon_complex(
                np.asarray(c) if not isinstance(c, (C64Bits, F64Bits,
                                                    jax.Array)) else c)
            if kind_c != "c128":
                # narrow c (complex64/f32): widening is exact — the
                # softfloat epilogue needs F64Bits operands
                c_re, c_im = (f64_to_bits(jnp.asarray(x, jnp.float64))
                              if backend_has_f64() else
                              f64_to_bits(np.asarray(jax.device_get(x),
                                                     np.float64))
                              for x in (c_re, c_im))
            rh, rl, ih, il = fn(ore.hi, ore.lo, oim.hi, oim.lo,
                                c_re.hi, c_re.lo, c_im.hi, c_im.lo)
        else:
            rh, rl, ih, il = fn(ore.hi, ore.lo, oim.hi, oim.lo)
        ore, oim = F64Bits(rh, rl), F64Bits(ih, il)
    res = C64Bits(ore, oim)
    # bits-domain contract, symmetric with the real path: a caller who
    # passed ANY bits operand (C64Bits or F64Bits) gets bits back
    if backend_has_f64() and not any(
            isinstance(x, (C64Bits, F64Bits)) for x in (a, b)):
        return jax.lax.complex(bits_to_f64(ore), bits_to_f64(oim))
    return res
