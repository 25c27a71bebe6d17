"""Residue-slice encoding (Ozaki Scheme II) as exact integer bit manipulation.

Given an FP64/FP32 operand, produce for each modulus m_j an int8 slice
    A8[j] == trunc(A * 2^sft_row) (mod m_j), centered in [-128, 127],
plus the per-row (or per-column) shift exponents `sft`, such that every
emulated dot product satisfies |sum_k trunc(a)*trunc(b)| <= (M-1)/2 and is
therefore exactly recoverable from its residues by CRT.

Design: all of this runs on raw IEEE-754 bit patterns with elementwise
int32 ops — exponent-field extraction, funnel shifts of the significand,
and Barrett-free modular reduction of 16-bit significand chunks against
precomputed 2^(16*i) mod m_j constants — so the slices are bit-identical on
every backend, whatever its float64 unit does. This replaces the
reference's f64 scalbn/trunc/FMA kernels (GEMMul8 src/scaling.hpp:155-230,
3371-3882) with integer arithmetic of identical mathematical effect.

Shift selection (fast mode, "vecnorm"): per row,
    sft = min(T-1, floor(-0.51*log2(nrm2_scaled) + T)) - ilogb(amax)
with T = floor(log2(M-1)/2 - 1.5) and nrm2_scaled the amax-normalized
round-up squared row norm — this enforces, via Cauchy-Schwarz,
||trunc(a*2^sftA)|| * ||trunc(b*2^sftB)|| <= 2^(2T+2) <= (M-1)/2.
(cf. reference scaling.hpp:3373-3383 and table.hpp:171-191.)

Accurate mode ("int8tc"): a 7-bit round-up magnitude extraction plus ONE
extra int8 GEMM |A|*|B| gives a true per-output product-magnitude bound;
shifts are then sft = sft7 + floor(-0.51*log2(rowmax S) + T') with
T' = floor(log2(M-1)/2 - 0.5) (cf. scaling.hpp:1502-1526, 3053-3136).

Subnormal inputs are handled exactly (exp_eff = 1, no implicit bit — same
value decomposition IEEE-754 defines; the reference reaches the same effect
through ilogb/scalbn). In the statistics pass a subnormal's magnitude is
rounded UP to the normal form with the same mantissa bits, which keeps the
norm-based shift bound conservative.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from .. import tables
from ..types import F64Bits
from .modmath import mod_u26

_U32 = jnp.uint32
_I32 = jnp.int32


# ---------------------------------------------------------------------------
# Significand chunking: the |value| is mant * 2^(q) with mant held as a list
# of 16-bit chunks (int32), little-endian. f64: 4 chunks (53 bits);
# f32: 2 chunks (24 bits).
# ---------------------------------------------------------------------------

def _f64_fields(hi: jax.Array, lo: jax.Array):
    """Bit fields of an f64 array: (chunks, exp_eff, sign, nonzero).

    value = sign * mant53 * 2^(exp_eff - 1075) with mant53 = sum of 16-bit
    chunks — exact for normals AND subnormals (subnormals keep exp_eff = 1
    and no implicit bit, per IEEE-754; the reference handles them via
    ilogb/scalbn, scaling.hpp). Inf/NaN inputs are undefined behavior,
    like the reference's."""
    hi = hi.astype(_U32)
    lo = lo.astype(_U32)
    exp = ((hi >> 20) & _U32(0x7FF)).astype(_I32)       # biased exponent
    sign = (hi >> 31).astype(_I32)
    is_normal = exp > 0
    nonzero = is_normal | (((hi & _U32(0xFFFFF)) | lo) != 0)
    c0 = (lo & _U32(0xFFFF)).astype(_I32)
    c1 = (lo >> 16).astype(_I32)
    c2 = (hi & _U32(0xFFFF)).astype(_I32)
    c3 = ((hi >> 16) & _U32(0xF)).astype(_I32) | jnp.where(is_normal,
                                                           _I32(0x10), _I32(0))
    chunks = [c0, c1, c2, c3]
    exp_eff = jnp.maximum(exp, _I32(1))
    return chunks, exp_eff, sign, nonzero


def _f32_fields(bits: jax.Array):
    """f32 analog of _f64_fields: value = sign * mant24 * 2^(exp_eff - 150),
    subnormal-exact (exp_eff = 1, no implicit bit)."""
    b = bits.astype(_U32)
    exp = ((b >> 23) & _U32(0xFF)).astype(_I32)
    sign = (b >> 31).astype(_I32)
    is_normal = exp > 0
    nonzero = is_normal | ((b & _U32(0x7FFFFF)) != 0)
    c0 = (b & _U32(0xFFFF)).astype(_I32)
    c1 = ((b >> 16) & _U32(0x7F)).astype(_I32) | jnp.where(is_normal,
                                                           _I32(0x80), _I32(0))
    chunks = [c0, c1]
    exp_eff = jnp.maximum(exp, _I32(1))
    return chunks, exp_eff, sign, nonzero


def _funnel_shift_right(chunks: Sequence[jax.Array], u: jax.Array):
    """Right-shift a multi-chunk (16-bit limbs in int32) integer by u in
    [0, 63], elementwise. Returns chunks of the shifted value.

    Packs the limbs into uint32 words and funnel-shifts those — ~3x fewer
    elementwise ops than per-limb select chains (this runs inside the
    encode hot kernel on every element)."""
    n = len(chunks)
    _U = jnp.uint32
    if n == 2:
        # f32 mantissa: 24 bits, one word
        w = (chunks[0].astype(_U) | (chunks[1].astype(_U) << 16))
        u1 = jnp.minimum(u, 31).astype(_U)
        s = jnp.where(u <= 31, w >> u1, _U(0)).astype(_I32)
        return [s & _I32(0xFFFF), (s >> 16) & _I32(0xFFFF)]
    assert n == 4
    lo = (chunks[0].astype(_U) | (chunks[1].astype(_U) << 16))
    hi = (chunks[2].astype(_U) | (chunks[3].astype(_U) << 16))
    u1 = jnp.minimum(u, 31).astype(_U)
    # ((hi << (31-u1)) << 1) == hi << (32-u1) without the u1=0 UB
    lo_sh = (lo >> u1) | ((hi << (_U(31) - u1)) << 1)
    hi_sh = hi >> u1
    u2 = jnp.clip(u - 32, 0, 31).astype(_U)
    res_lo = jnp.where(u < 32, lo_sh, hi >> u2).astype(_I32)
    res_hi = jnp.where(u < 32, hi_sh, _U(0)).astype(_I32)
    return [res_lo & _I32(0xFFFF), (res_lo >> 16) & _I32(0xFFFF),
            res_hi & _I32(0xFFFF), (res_hi >> 16) & _I32(0xFFFF)]


def _shifted_value_words(chunks, q, mant_bits: int, q_max_static: int):
    """Packed uint32 words of v = trunc(mant * 2^q), elementwise.

    q < 0 truncates (right shift); 0 <= q <= q_max_static scales up (left
    shift). The word count covers mant_bits + 1 + q_max_static bits so the
    left shift is exact — this replaces the old per-modulus power-of-two
    ladder (an extra modular reduction per modulus) with a handful of
    shared shift ops."""
    _U = jnp.uint32
    if len(chunks) == 2:
        words = [chunks[0].astype(_U) | (chunks[1].astype(_U) << 16)]
    else:
        words = [chunks[0].astype(_U) | (chunks[1].astype(_U) << 16),
                 chunks[2].astype(_U) | (chunks[3].astype(_U) << 16)]
    # right shift by ur in [0, 63]
    ur = jnp.clip(-q, 0, 63)
    u1 = jnp.minimum(ur, 31).astype(_U)
    if len(words) == 1:
        rw = [jnp.where(ur <= 31, words[0] >> u1, _U(0))]
    else:
        lo, hi = words
        lo_sh = (lo >> u1) | ((hi << (_U(31) - u1)) << 1)
        hi_sh = hi >> u1
        u2 = jnp.clip(ur - 32, 0, 31).astype(_U)
        rw = [jnp.where(ur < 32, lo_sh, hi >> u2),
              jnp.where(ur < 32, hi_sh, _U(0))]
    if q_max_static <= 0:
        return rw
    # left shift by ql in [0, q_max_static], q_max_static < 64 (f64 tops
    # out at T-1-52 = 26 for 20 moduli; f32 at T-1-23 = 50 for 19 moduli):
    # dynamic word-level shift (0 or 1 words) + in-word bit shift.
    assert q_max_static < 64
    nw_out = (mant_bits + 1 + q_max_static + 31) // 32
    ql = jnp.clip(q, 0, q_max_static)
    b = (ql & 31).astype(_U)
    zero = jnp.zeros_like(rw[0])
    padded = [zero, zero] + rw + [zero] * max(nw_out - len(rw), 0)

    def at(i):  # padded index of logical input word i (i may be < 0)
        return padded[i + 2]

    out = []
    if q_max_static < 32:
        # whole-word shift is statically 0 (ql <= q_max_static < 32):
        # the word-select ladder folds away (the common f64 case — e.g.
        # q_max_static = 1 at 14 moduli)
        for i in range(nw_out):
            out.append((at(i) << b) | ((at(i - 1) >> (_U(31) - b)) >> 1))
        return out
    wsh = ql >> 5           # 0 or 1 whole words
    for i in range(nw_out):
        lo0, hi0 = at(i), at(i - 1)        # wsh == 0 sources
        lo1, hi1 = at(i - 1), at(i - 2)    # wsh == 1 sources
        lo = jnp.where(wsh == 0, lo0, lo1)
        hi = jnp.where(wsh == 0, hi0, hi1)
        out.append((lo << b) | ((hi >> (_U(31) - b)) >> 1))
    return out


def _residues_from_chunks(chunks, q, sign, normal, moduli_idx,
                          q_max_static: int):
    """Centered residues of sign * (chunked mant) * 2^q for each modulus in
    moduli_idx (a tuple of indices into tables.MODULI — a subrange when the
    low-memory moduli-chunked schedule is active).

    q may be negative (right shift / truncation) or positive up to
    q_max_static (pure magnitude scaling, folded into the shared shift)."""
    mant_bits = 53 if len(chunks) == 4 else 24
    words = _shifted_value_words(chunks, q, mant_bits, q_max_static)
    d = []
    for w in words:
        d.append((w & jnp.uint32(0xFFFF)).astype(_I32))
        d.append((w >> 16).astype(_I32))
    # drop statically-zero top chunks
    total_bits = mant_bits + 1 + max(q_max_static, 0)
    d = d[: (total_bits + 15) // 16]
    # acc bound: nc * 255 * 65535 -> <= 4 chunks fit 2^26, 5-6 chunks 2^27
    bound = 26 if len(d) <= 4 else 27
    neg = (sign == 1)

    # No per-modulus `normal` masking is needed: a zero input (the only
    # ~normal case; inf/nan are documented UB) has all-zero chunks, so the
    # shifted words, every accumulator, and the centered residues are
    # already exactly 0 — including -0.0, whose negation below is -0 = 0.
    out = []
    for j in moduli_idx:
        m = int(tables.MODULI[j])
        if m == 256:
            # two's-complement wraparound: the centered residue mod 256 is
            # the sign-extended low byte of the signed value
            lob = d[0] & _I32(0xFF)
            sv = jnp.where(neg, (_I32(256) - lob) & _I32(0xFF), lob)
            rc = (sv ^ _I32(0x80)) - _I32(0x80)
            out.append(rc.astype(jnp.int8))
            continue
        acc = jnp.zeros_like(d[0])
        for i, di in enumerate(d):
            p = (1 << (16 * i)) % m
            if p == 1:       # 2^0 mod m (and any p==1): skip the multiply
                acc = acc + di
            elif p != 0:
                acc = acc + di * _I32(p)
        base = mod_u26(acc, m, bound)
        # center |v| mod m into the symmetric range, then apply the sign:
        # for odd m the centered range [-(m-1)/2, (m-1)/2] is symmetric,
        # so negating the centered residue equals the residue of -v
        rc = base - jnp.where(base >= _I32((m + 1) // 2), _I32(m), _I32(0))
        rc = jnp.where(neg, -rc, rc)
        out.append(rc.astype(jnp.int8))
    return jnp.stack(out, axis=0)


# ---------------------------------------------------------------------------
# Row/column statistics and shift selection.
# ---------------------------------------------------------------------------

def _scaled_abs_f32(chunks, exp, emax, normal, mant_bits: int):
    """|x| * 2^-(ilogb of row max) as f32 in [0, 2): exact exponent-field
    arithmetic, top-23-bit mantissa."""
    # f32 biased exponent of the scaled value
    eb = exp - emax + _I32(127)
    if mant_bits == 53:
        m23 = ((chunks[3] & _I32(0xF)) << 19) | (chunks[2] << 3) | (chunks[1] >> 13)
    else:
        m23 = ((chunks[1] & _I32(0x7F)) << 16) | chunks[0]
    f32bits = ((eb << 23) | m23).astype(_U32)
    val = jax.lax.bitcast_convert_type(f32bits, jnp.float32)
    return jnp.where(normal & (eb >= 1), val, jnp.float32(0))


def _fast_sft_multi(parts, axis: int, num_moduli: int, mant_bits: int,
                    axis_name=None):
    """Fast-mode ('vecnorm') per-row/col shift selection over one or more
    'parts' sharing the shift (real: one part; complex: Re and Im jointly,
    since block-encoded rows/cols mix both — cf. reference complex scaling
    kernels, scaling.hpp:3435-3678). Each part is (chunks, exp, sign,
    normal).

    axis_name: mesh axis the contraction dim is sharded over (inside
    shard_map) — stats then psum/pmax across shards so every shard picks
    the same globally-valid shift.

    Order note: the squared norm is an f32 sum whose order is the
    backend's own (XLA's CPU and GPU reductions differ). The values can
    differ in the last ulp, so shifts agree across backends except when
    the shift formula lands within f32 summation-order noise of a floor
    boundary — then they may legally differ by 1 (both shifts are valid
    encodings; see sft_floor_frac)."""
    emax, nrm2, anyfinite, k = _fast_stats_multi(parts, axis, mant_bits,
                                                 axis_name)
    # one shift formula for every path (sft_floor_frac mirrors it)
    sft = sft_from_stats(emax, nrm2, anyfinite, k, num_moduli, mant_bits)
    return sft, emax


def _fast_stats_multi(parts, axis: int, mant_bits: int, axis_name=None):
    """Raw fast-mode statistics (emax, nrm2, anyfinite, k_total) for one or
    more parts sharing the shift — the input to sft_from_stats."""
    emax = None
    for chunks, exp, sign, normal in parts:
        e = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
        emax = e if emax is None else jnp.maximum(emax, e)
    if axis_name is not None:
        emax = jax.lax.pmax(emax, axis_name)
    nrm2 = None
    k = 0
    anyfinite = None
    for chunks, exp, sign, normal in parts:
        xs = _scaled_abs_f32(chunks, exp, emax, normal, mant_bits)
        k += xs.shape[axis]
        s = jnp.sum(xs * xs, axis=axis, keepdims=True, dtype=jnp.float32)
        nrm2 = s if nrm2 is None else nrm2 + s
        af = jnp.any(normal, axis=axis, keepdims=True)
        anyfinite = af if anyfinite is None else anyfinite | af
    if axis_name is not None:
        nrm2 = jax.lax.psum(nrm2, axis_name)
        anyfinite = jax.lax.psum(anyfinite.astype(_I32), axis_name) > 0
        k = k * jax.lax.axis_size(axis_name)
    return emax, nrm2, anyfinite, k


def _fast_sft(chunks, exp, normal, axis: int, num_moduli: int,
              mant_bits: int, axis_name=None):
    return _fast_sft_multi([(chunks, exp, None, normal)], axis, num_moduli,
                           mant_bits, axis_name)


def _encode_with_sft(chunks, exp, sign, normal, sft, num_moduli: int,
                     mant_bits: int, moduli_idx=None):
    mant_shift = 1075 if mant_bits == 53 else 150
    q = exp - _I32(mant_shift) + sft
    t_a = tables.threshold_accurate(num_moduli)
    q_max_static = max(t_a - 1 - (mant_bits - 1), 0)
    if moduli_idx is None:
        moduli_idx = tuple(range(num_moduli))
    return _residues_from_chunks(chunks, q, sign, normal, moduli_idx,
                                 q_max_static)


# ---------------------------------------------------------------------------
# Public encode entry points. `axis` is the contraction axis of the operand:
# for A (m, k) pass axis=1 (row stats); for B (k, n) pass axis=0 (col stats).
# ---------------------------------------------------------------------------

def encode_fast_f64(bits: F64Bits, num_moduli: int, axis: int,
                    axis_name=None, moduli_idx=None):
    """Fast-mode encode of an f64 operand. Returns (slices (L, *shape) int8,
    sft int32 with keepdims shape)."""
    chunks, exp, sign, normal = _f64_fields(bits.hi, bits.lo)
    sft, _ = _fast_sft(chunks, exp, normal, axis, num_moduli, 53, axis_name)
    slices = _encode_with_sft(chunks, exp, sign, normal, sft, num_moduli, 53,
                              moduli_idx)
    return slices, sft


def encode_fast_f32(x: jax.Array, num_moduli: int, axis: int,
                    axis_name=None, moduli_idx=None):
    """Fast-mode encode of an f32 operand (native f32 array)."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), _U32)
    chunks, exp, sign, normal = _f32_fields(bits)
    sft, _ = _fast_sft(chunks, exp, normal, axis, num_moduli, 24, axis_name)
    slices = _encode_with_sft(chunks, exp, sign, normal, sft, num_moduli, 24,
                              moduli_idx)
    return slices, sft


# ---------------------------------------------------------------------------
# Accurate mode ("int8tc"): 7-bit round-up magnitudes -> one int8 GEMM
# |A|*|B| -> per-row/col product-magnitude-based shifts -> encode.
# ---------------------------------------------------------------------------

def _extract_mag7(chunks, exp, normal, emax, mant_bits: int,
                  mag_shift: int = 5):
    """ceil(|x| * 2^(mag_shift - ilogb(amax))) as int8 in [0, 2^(mag_shift+1)]
    (round-up magnitude; cf. reference scaling.hpp:1508-1524). mag_shift=5
    gives the reference's 7-bit magnitudes (<= 64); complex uses 4 so the
    Re+Im sum stays <= 64 inside int8 (128 would wrap to -128).

    Single packed pass: only the LOW word of the shifted value survives
    (result < 2^(mag_shift+2)), so the funnel skips the upper outputs and
    the sticky shares the packed words (vs the old full funnel +
    per-limb dropped_nonzero — this is the accurate pre-phase's hot
    elementwise kernel, VERDICT r4 item 2)."""
    # |x| = mant * 2^(exp - bias - (mant_bits-1)); scaled by
    # 2^(mag_shift-(emax-bias)): shift u = emax + mant_bits-1-mag_shift - exp
    u = jnp.clip(emax + _I32(mant_bits - 1 - mag_shift) - exp, 0, 63)
    _U = jnp.uint32
    w0 = chunks[0].astype(_U) | (chunks[1].astype(_U) << 16)
    u1 = jnp.minimum(u, 31).astype(_U)
    if len(chunks) == 2:
        lo = jnp.where(u <= 31, w0 >> u1, _U(0))
        # dropped = low u bits of w0 (value < 2^24 <= one word)
        m0 = jnp.where(u >= 32, _U(0xFFFFFFFF), (_U(1) << u1) - _U(1))
        sticky = (w0 & m0) != 0
    else:
        w1 = chunks[2].astype(_U) | (chunks[3].astype(_U) << 16)
        lo_sh = (w0 >> u1) | ((w1 << (_U(31) - u1)) << 1)
        u2 = jnp.clip(u - 32, 0, 31).astype(_U)
        lo = jnp.where(u < 32, lo_sh, w1 >> u2)
        # dropped bits: word 0 fully below when u >= 32, else its low u
        # bits; word 1 contributes its low (u-32) bits only when u > 32
        m0 = jnp.where(u >= 32, _U(0xFFFFFFFF), (_U(1) << u1) - _U(1))
        m1 = (_U(1) << u2) - _U(1)
        sticky = ((w0 & m0) != 0) | ((w1 & m1) != 0)
    v = lo.astype(_I32) + sticky.astype(_I32)
    # zero inputs (the only ~normal case) have zero chunks -> v == 0
    # already; no mask needed
    return v.astype(jnp.int8)


def mag7_f64(bits: F64Bits, axis: int):
    chunks, exp, sign, normal = _f64_fields(bits.hi, bits.lo)
    emax = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
    return _extract_mag7(chunks, exp, normal, emax, 53), emax


def mag7_sharded(x, axis: int, axis_name, mag_shift: int = 5):
    """Accurate-mode magnitude extraction when the reduction axis is
    sharded over `axis_name`: the max exponent is pmax'd across shards
    BEFORE extraction so every shard aligns to the same global emax."""
    if isinstance(x, F64Bits):
        chunks, exp, sign, normal = _f64_fields(x.hi, x.lo)
        mant_bits = 53
    else:
        bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), _U32)
        chunks, exp, sign, normal = _f32_fields(bits)
        mant_bits = 24
    emax = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
    emax = jax.lax.pmax(emax, axis_name)
    return _extract_mag7(chunks, exp, normal, emax, mant_bits,
                         mag_shift), emax


def mag7_f32(x: jax.Array, axis: int):
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), _U32)
    chunks, exp, sign, normal = _f32_fields(bits)
    emax = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
    return _extract_mag7(chunks, exp, normal, emax, 24), emax


def accurate_sft(smax: jax.Array, emax: jax.Array, num_moduli: int,
                 mant_bits: int, mag_shift: int = 5):
    """Accurate-mode shift from the |A|*|B| product-magnitude row/col max.

    smax: int32 (keepdims shape) max over the int8 magnitude GEMM output,
    whose operands were extracted with `mag_shift` (see _extract_mag7).
    sft = (mag_shift - ilogb(amax)) + floor(-0.51*log2(smax) + T_accu),
    capped so the per-element magnitude stays below 2^(T_accu)."""
    t_a = tables.threshold_accurate(num_moduli)
    bias = 1023 if mant_bits == 53 else 127
    e = emax - _I32(bias)
    s = jnp.maximum(smax, 1).astype(jnp.float32)
    sft = (_I32(mag_shift) - e
           + jnp.floor(-0.51 * jnp.log2(s) + t_a).astype(_I32))
    sft = jnp.minimum(sft, _I32(t_a - 1) - e)
    return sft


def encode_accurate_f64(bits: F64Bits, sft: jax.Array, num_moduli: int,
                        moduli_idx=None):
    chunks, exp, sign, normal = _f64_fields(bits.hi, bits.lo)
    return _encode_with_sft(chunks, exp, sign, normal, sft, num_moduli, 53,
                            moduli_idx)


def encode_accurate_f32(x: jax.Array, sft: jax.Array, num_moduli: int,
                        moduli_idx=None):
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), _U32)
    chunks, exp, sign, normal = _f32_fields(bits)
    return _encode_with_sft(chunks, exp, sign, normal, sft, num_moduli, 24,
                            moduli_idx)


# ---------------------------------------------------------------------------
# Complex: Re and Im of each row/col share one shift (block encodings mix
# them in one dot product), so stats are joint over both parts.
# ---------------------------------------------------------------------------

def _complex_parts(re, im):
    """(parts, mant_bits) for a complex operand given as two same-typed
    real operands (F64Bits or f32 arrays)."""
    if isinstance(re, F64Bits):
        return ([_f64_fields(re.hi, re.lo), _f64_fields(im.hi, im.lo)], 53)
    br = jax.lax.bitcast_convert_type(re.astype(jnp.float32), _U32)
    bi = jax.lax.bitcast_convert_type(im.astype(jnp.float32), _U32)
    return ([_f32_fields(br), _f32_fields(bi)], 24)


def encode_fast_complex(re, im, num_moduli: int, axis: int, axis_name=None):
    """Joint fast-mode encode of a complex operand.
    Returns (re8, im8, sft): (L, *shape) int8 slices for each part and the
    shared shift. axis_name: mesh axis for cross-shard stats (see
    _fast_sft_multi)."""
    parts, mant_bits = _complex_parts(re, im)
    sft, _ = _fast_sft_multi(parts, axis, num_moduli, mant_bits, axis_name)
    outs = []
    for chunks, exp, sign, normal in parts:
        outs.append(_encode_with_sft(chunks, exp, sign, normal, sft,
                                     num_moduli, mant_bits))
    return outs[0], outs[1], sft


MAG_SHIFT_COMPLEX = 4  # parts <= 32, Re+Im sum <= 64: safe in int8


def mag7_complex(re, im, axis: int):
    """Round-up magnitude bound for a complex operand: uses
    |re| + |im| >= |z| so the accurate-mode product estimate stays an
    upper bound. Extraction uses mag_shift=4 (one bit less than the real
    path) because the per-part bound is 2^(mag_shift+1) and the Re+Im sum
    must fit int8 — at mag_shift=5 two maximal parts sum to 128, which
    wraps to -128 and silently corrupts the shift selection."""
    parts, mant_bits = _complex_parts(re, im)
    emax = None
    for chunks, exp, sign, normal in parts:
        e = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
        emax = e if emax is None else jnp.maximum(emax, e)
    mags = [
        _extract_mag7(chunks, exp, normal, emax, mant_bits,
                      MAG_SHIFT_COMPLEX).astype(_I32)
        for chunks, exp, sign, normal in parts
    ]
    return (mags[0] + mags[1]).astype(jnp.int8), emax


def encode_accurate_complex(re, im, sft, num_moduli: int):
    parts, mant_bits = _complex_parts(re, im)
    outs = [
        _encode_with_sft(chunks, exp, sign, normal, sft, num_moduli,
                         mant_bits)
        for chunks, exp, sign, normal in parts
    ]
    return outs[0], outs[1]


def sft_from_stats(emax, nrm2, anyfinite, k_total: int, num_moduli: int,
                   mant_bits: int):
    """Fast-mode shift from (possibly cross-shard-combined) raw statistics:
    emax = max biased exponent, nrm2 = squared norm relative to 2^emax,
    anyfinite = any nonzero flag, k_total = GLOBAL contraction length (the
    round-up guard must cover the full sum even when stats were combined
    over shards)."""
    t_f = tables.threshold_fast(num_moduli)
    bias = 1023 if mant_bits == 53 else 127
    nrm2 = jnp.maximum(nrm2 * jnp.float32(1.0 + k_total * 2.0 ** -23),
                       jnp.float32(1.0))
    lgn = jnp.log2(nrm2)
    sft = (jnp.minimum(_I32(t_f - 1),
                       jnp.floor(-0.51 * lgn + t_f).astype(_I32))
           - (emax - _I32(bias)))
    return jnp.where(anyfinite > 0, sft, _I32(0))


def sft_floor_frac(nrm2, k_total: int, num_moduli: int):
    """Distance of sft_from_stats' pre-floor value from its nearest
    integer, per row/col. Cross-backend comparisons use this: two backends
    sum the f32 squared norm in different orders, so nrm2 can differ in
    the last ulp and the floored shift may legally differ by 1 exactly
    when this distance is within f32 summation noise. MUST share its
    constants with sft_from_stats — a drift between the two would let a
    comparison misclassify real parity bugs as boundary noise."""
    t_f = tables.threshold_fast(num_moduli)
    n2 = jnp.maximum(jnp.asarray(nrm2, jnp.float32)
                     * jnp.float32(1.0 + k_total * 2.0 ** -23),
                     jnp.float32(1.0))
    v = -0.51 * jnp.log2(n2) + t_f
    return jnp.minimum(v - jnp.floor(v), jnp.ceil(v) - v)
