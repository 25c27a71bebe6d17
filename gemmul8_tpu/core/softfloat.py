"""Exact-rounded IEEE-754 binary64 arithmetic on bit patterns (softfloat).

The alpha/beta GEMM epilogue (C = alpha*AB + beta*C, reference
inverse_scaling.hpp:269-820 epilogue variants) works on the F64Bits the
reconstruction produces and needs true f64 semantics on any backend. These
add/mul operate on F64Bits with pure int32 ops: decompose -> limb
arithmetic -> round-to-nearest-even via the same normalization/rounding core the CRT reconstruction uses
(reconstruct._round_to_float), so results are correctly rounded, matching
CPU f64 bit-for-bit (asserted in tests/test_softfloat.py).

Scope: finite arithmetic incl. subnormals, signed zero, overflow->inf.
NaN/Inf inputs propagate as Inf/NaN but without full IEEE payload rules.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import F64Bits
from . import limbs as lb
from .reconstruct import _assemble_f64, _round_to_float

_I32 = jnp.int32
_U32 = jnp.uint32


def const_f64(x: float, shape) -> F64Bits:
    u = np.float64(x).view(np.uint64).item()
    hi = jnp.full(shape, np.uint32(u >> 32), _U32)
    lo = jnp.full(shape, np.uint32(u & 0xFFFFFFFF), _U32)
    return F64Bits(hi, lo)


def _decompose(x: F64Bits):
    """-> (sign, eeff, mant_limbs[4]) with value = (-1)^sign * mant * 2^(eeff-1075);
    eeff = max(exp_field, 1) so subnormals are uniform; also returns
    is_inf/is_nan flags."""
    hi = x.hi.astype(_U32)
    lo = x.lo.astype(_U32)
    exp = ((hi >> 20) & _U32(0x7FF)).astype(_I32)
    sign = (hi >> 31).astype(_I32)
    normal = exp > 0
    special = exp == 0x7FF
    mant_nonzero = ((hi & _U32(0xFFFFF)) != 0) | (lo != 0)
    is_nan = special & mant_nonzero
    is_inf = special & ~mant_nonzero
    c0 = (lo & _U32(0xFFFF)).astype(_I32)
    c1 = (lo >> 16).astype(_I32)
    c2 = (hi & _U32(0xFFFF)).astype(_I32)
    c3 = ((hi >> 16) & _U32(0xF)).astype(_I32) | jnp.where(
        normal & ~special, _I32(0x10), _I32(0))
    eeff = jnp.maximum(exp, 1)
    return sign, eeff, [c0, c1, c2, c3], is_inf, is_nan


def _specials(out: F64Bits, flags, sign_out) -> F64Bits:
    is_inf, is_nan = flags
    inf_hi = (sign_out.astype(_I32) << 31) | _I32(0x7FF00000)
    hi = jnp.where(is_nan, _I32(0x7FF80000),
                   jnp.where(is_inf, inf_hi, out.hi.astype(_I32)))
    lo = jnp.where(is_nan | is_inf, _I32(0), out.lo.astype(_I32))
    return F64Bits(hi.astype(_U32), lo.astype(_U32))


def mul(a: F64Bits, b: F64Bits) -> F64Bits:
    sa, ea, ma, inf_a, nan_a = _decompose(a)
    sb, eb, mb, inf_b, nan_b = _decompose(b)
    neg = (sa ^ sb) == 1
    # 53x53-bit product in limbs: split b into 8-bit chunks so every
    # partial product fits int32 (16b * 8b = 24b, <= 7 summands per column
    # at 8-bit granularity -> < 2^27).
    b8 = []
    for c in mb:
        b8.append(c & _I32(0xFF))
        b8.append(c >> 8)
    # accumulate at 8-bit positions: product has <= 107 bits -> 14 bytes
    acc8 = [jnp.zeros_like(ma[0]) for _ in range(16)]
    for i, ai in enumerate(ma):          # position 16*i
        for j, bj in enumerate(b8):      # position 8*j
            pos = 2 * i + j              # in bytes
            acc8[pos] = acc8[pos] + ai * bj
    # byte-level carry propagation (acc8[t] < 2^26), then pack 16-bit limbs
    carry = jnp.zeros_like(acc8[0])
    bytes_ = []
    for t in range(16):
        v = acc8[t] + carry
        bytes_.append(v & _I32(0xFF))
        carry = v >> 8
    mag = [bytes_[2 * t] | (bytes_[2 * t + 1] << 8) for t in range(8)]
    e_fix = (ea - _I32(1075)) + (eb - _I32(1075))
    ebits, mant = _round_to_float(mag, neg, e_fix, 53)
    out = _assemble_f64(neg, ebits, mant)
    # specials: inf*finite=inf, 0*inf=nan, nan anywhere=nan
    a_zero = _is_zero_mant(ma) & ~inf_a & ~nan_a
    b_zero = _is_zero_mant(mb) & ~inf_b & ~nan_b
    is_nan = nan_a | nan_b | (inf_a & b_zero) | (inf_b & a_zero)
    is_inf = (inf_a | inf_b) & ~is_nan
    return _specials(out, (is_inf, is_nan), neg)


def _is_zero_mant(m):
    z = m[0] == 0
    for c in m[1:]:
        z = z & (c == 0)
    return z


def add(a: F64Bits, b: F64Bits) -> F64Bits:
    sa, ea, ma, inf_a, nan_a = _decompose(a)
    sb, eb, mb, inf_b, nan_b = _decompose(b)
    a_zero = _is_zero_mant(ma)
    b_zero = _is_zero_mant(mb)
    # order so that |x| >= |y| (compare (eeff, mant) lexicographically)
    mant_ge = _mant_geq(ma, mb)
    a_ge = (ea > eb) | ((ea == eb) & mant_ge)
    sx = jnp.where(a_ge, sa, sb)
    sy = jnp.where(a_ge, sb, sa)
    ex = jnp.where(a_ge, ea, eb)
    ey = jnp.where(a_ge, eb, ea)
    mx = lb.select(a_ge, ma, mb)
    my = lb.select(a_ge, mb, ma)
    # frame: x mantissa << 3 guard bits; y shifted into the same frame
    mx3 = lb.carry_propagate([c << 3 for c in mx] + [jnp.zeros_like(mx[0])])
    my3 = [c << 3 for c in my] + [jnp.zeros_like(my[0])]
    my3 = lb.carry_propagate(my3)
    d = jnp.clip(ex - ey, 0, 63)
    my_sh = lb.shift_right(my3, d, 5)
    sticky = lb.dropped_nonzero(my3, d) & (ex - ey > 0)
    # fold sticky into bit 0 (3 guard bits above -> RN-correct)
    my_sh[0] = my_sh[0] | sticky.astype(_I32)
    same_sign = sx == sy
    added = lb.carry_propagate([px + py for px, py in zip(mx3, my_sh)])
    subbed, _ = lb.sub(mx3, my_sh)
    mag = lb.select(same_sign, added, subbed)
    neg = sx == 1
    e_fix = ex - _I32(1075) - _I32(3)
    ebits, mant = _round_to_float(mag, neg, e_fix, 53)
    out = _assemble_f64(neg, ebits, mant)
    # exact cancellation -> +0 (RN mode), unless both were -0
    cancel = _is_zero_mant(mag) & ~(a_zero & b_zero)
    hi = jnp.where(cancel, _I32(0), out.hi.astype(_I32))
    both_zero = a_zero & b_zero
    hi = jnp.where(both_zero, (sa & sb) << 31, hi)
    out = F64Bits(hi.astype(_U32), jnp.where(cancel | both_zero, _U32(0),
                                             out.lo))
    is_nan = nan_a | nan_b | (inf_a & inf_b & (sa != sb))
    is_inf = (inf_a | inf_b) & ~is_nan
    sign_inf = jnp.where(inf_a, sa, sb)
    return _specials(out, (is_inf, is_nan), sign_inf)


def sub(a: F64Bits, b: F64Bits) -> F64Bits:
    nb = F64Bits((b.hi.astype(_U32) ^ _U32(0x80000000)), b.lo)
    return add(a, nb)


def _mant_geq(a, b):
    ge = jnp.ones_like(a[0])
    for xa, xb in zip(a, b):
        ge = jnp.where(xa > xb, _I32(1), jnp.where(xa < xb, _I32(0), ge))
    return ge == 1
