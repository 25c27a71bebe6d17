"""Exact CRT reconstruction + inverse scaling.

Recovers C_ij = (sum_j' w_j' * r_j' mod M, centered) * 2^-(sftA_i + sftB_j)
from the per-modulus residues of the slice products, exactly rounded
(round-to-nearest-even) to the target dtype.

Replacement for the reference's f64/double-double CRT kernels
(GEMMul8 src/inverse_scaling.hpp:35-1005): instead of
floating-point NMi weights with mod-M recentering in double-double, we
accumulate the full integer X = sum w_j * r_j in 16-bit int32 limbs (exact),
reduce mod M with a float-estimated quotient plus exact correction steps,
center to (-M/2, M/2), and round the scaled result directly into IEEE-754
bit patterns.  This is exact — strictly tighter than the reference's FP
reconstruction — and is all elementwise int32 work that XLA fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import tables
from ..types import F64Bits
from . import limbs as lb

_I32 = jnp.int32
_U32 = jnp.uint32


def accumulate_weighted(r: jax.Array, num_moduli: int, moduli_idx=None,
                        acc=None):
    """acc += sum_j crt_weight[j] * r[j] in 16-bit limbs (canonicalized).

    r: (len(moduli_idx), ...) int32 canonical residues in [0, m_j) —
    an array or a list of per-modulus arrays (kernels index residue
    scratch slices without stacking them).
    Additive over moduli chunks, which is what makes the low-memory
    moduli-chunked schedule possible: residue slices for a chunk are
    encoded, multiplied, folded in here, and then freed before the next
    chunk is materialized.  Returns canonical limb list (length
    tables.num_limbs(num_moduli))."""
    nl = tables.num_limbs(num_moduli)
    w = tables.crt_weight_limbs(num_moduli)  # (L, nl) ints < 2^16
    if moduli_idx is None:
        moduli_idx = tuple(range(num_moduli))
    out = [jnp.zeros(r[0].shape, _I32) for _ in range(nl)] \
        if acc is None else list(acc)
    for jj, j in enumerate(moduli_idx):
        rj = r[jj]
        for l in range(nl):
            wl = int(w[j, l])
            if wl == 1:      # skip the multiply
                out[l] = out[l] + rj
            elif wl:
                out[l] = out[l] + rj * _I32(wl)
    # partial sums < 20 * 255 * 65535 < 2^29 (+ canonical acc < 2^16): safe;
    # one carry pass canonicalizes.
    return lb.carry_propagate(out)


def _mod_m_centered(x, num_moduli: int):
    """Reduce limbs x (0 <= x < 255*L*M) mod M and center.

    x may be CANONICAL (16-bit limbs) or REDUNDANT with each nonnegative
    limb < 2^29 (a digit assembly that skips its carry pass) — the
    quotient budget below covers both.
    Returns (mag_limbs, neg) with value = (-1)^neg * mag, mag <= M/2."""
    nl = len(x)
    mm = tables.big_m(num_moduli)
    m_limbs = [int(v) for v in tables.big_m_limbs(num_moduli)]
    nb = mm.bit_length()

    # Quotient estimate t = floor(X / M), t < 255*num_moduli + 1.
    # Use f32 top-limb approximation biased low, then correct upward.
    top = (nb - 1) // 16  # index of M's top nonzero limb
    scale = 16 * (top - 1)
    xf = jnp.zeros(x[0].shape, jnp.float32)
    for l in range(max(top - 1, 0), nl):
        xf = xf + x[l].astype(jnp.float32) * jnp.float32(2.0 ** (16 * l - scale))
    mf = float((mm >> scale) + 1) if scale >= 0 else float(mm << -scale)
    # mf slightly over-estimates M in the same scale -> t_est <= t always
    # (xf under-estimates X up to its f32 roundings, and the 2^-18 margin
    # dominates those roundings since t <= 255*num_moduli < 2^12).  The
    # division is folded into one compile-time reciprocal constant rounded
    # TOWARD ZERO, so rinv <= (1 - 2^-18)/mf exactly and the only runtime
    # rounding on the safe side is the single product (2^-24 < margin) —
    # saves a divide (several Newton steps) per element.
    rinv = float(np.nextafter(np.float32((1.0 - 2.0 ** -18) / mf),
                              np.float32(0.0)))
    # no max(t_est, 0) needed: xf >= 0 and rinv > 0, so the floor is >= 0
    t_est = jnp.floor(xf * jnp.float32(rinv)).astype(_I32)
    x, _ = lb.scale_const_sub(x, t_est, m_limbs)
    # Undershoot bound (canonical x): t - t_est <= t*(2*2^-16 + 2^-18 +
    # 2*2^-24) + 1 < 0.15 + 1 < 2 (xf limb truncation and mf granularity
    # are each <= 2^-16 relative, rinv's down-rounding and the product
    # rounding <= 2^-24 each, t <= 255*num_moduli < 2^12, plus the
    # floor). Redundant x (limbs < 2^29): xf additionally drops the
    # sub-(top-1) limbs' excess mass <= 2^29 * 2^(16*(top-2)) * 1.01
    # <= M/8 (M >= 2^(16*top)), so t - t_est < 0.15 + 0.13 + 1 < 1.5.
    # Either way t - t_est is an integer in {0, 1} (and never negative:
    # t_est <= t by the floor-biased construction), so after subtracting
    # t_est*M the remainder x = (t - t_est)*M + (X mod M) is < 2*M —
    # ONE borrow-selected subtraction completes the reduction (the second
    # x-2M chain round 4 carried was slack beyond this proof; ~40 vector
    # ops/element retired). (scale_const_sub's masking also canonicalizes
    # redundant input limbs as it goes; its intermediates stay < 2^30.)
    d1, b1 = lb.sub_const(x, m_limbs)            # x - M (borrow chain)
    r = lb.select(b1 != 0, x, d1)                # r in [0, M)
    half1 = [int(v) for v in _const_limbs(mm // 2 + 1, nl)]
    bh = lb.sub_const_borrow(r, half1)           # bh == 0  <=>  r > M/2
    neg = bh == 0
    g = lb.const_minus(m_limbs, r)               # M - r (magnitude there)
    mag = lb.select(neg, g, r)
    # mag <= M/2 < 2^(bits(M)-1): the accumulator-sized top limbs are
    # provably zero — drop them so the rounding chain (msb scan, funnel
    # shifts, sticky) runs on fewer limbs. M is never a power of two, so
    # floor(M/2) fits exactly (bits(M)-1) bits.
    n_mag = (mm.bit_length() - 1 + 15) // 16
    return mag[:n_mag], neg


def _const_limbs(v: int, n: int):
    return [(v >> (16 * i)) & 0xFFFF for i in range(n)]


def _round_to_float(mag, neg, e_fix, mant_bits: int):
    """Exactly round value = (-1)^neg * mag * 2^e_fix to an IEEE float.

    mag: canonical limb list; e_fix: int32 exponent (elementwise);
    mant_bits: 53 for f64, 24 for f32.
    Returns (sign, biased_exp, mant_chunks) with the implicit bit stripped,
    handling subnormals, zero, and overflow->inf."""
    emax_field = 0x7FF if mant_bits == 53 else 0xFF
    bias = 1023 if mant_bits == 53 else 127
    n_mant_chunks = 4 if mant_bits == 53 else 2

    p = lb.msb_position(mag)          # -1 if zero
    is_zero = p < 0
    # Unbiased exponent of the value; biased field before subnormal handling
    eb = p + e_fix + _I32(bias)
    # Right-shift amount to put MSB at bit (mant_bits-1), plus subnormal
    # extension when eb <= 0.
    sr = p - _I32(mant_bits - 1) + jnp.maximum(0, 1 - eb)
    # Static pre-shift: shift mag * 2^(16*PRE) right by sr + 16*PRE, which
    # is always >= 0 (-sr <= mant_bits <= 16*PRE for nonzero mag, and the
    # subnormal extension only raises sr; mag == 0 is forced to zero at the
    # end).  One funnel pass replaces the old right-funnel + left-funnel +
    # select triple: the pre-shift's zero limbs are static, so their ladder
    # entries and sticky masks fold away inside shift_right_round.
    pre = n_mant_chunks              # 16*4=64 > 53 (f64); 16*2=32 > 24 (f32)
    # lower clamp provably dead: -sr <= mant_bits <= 16*pre (and the
    # subnormal extension only raises sr), so u > 0 for nonzero mag; the
    # upper clamp keeps the funnel's word-select ladder in range — any
    # u >= 16*(len+pre)+1 shifts every bit out (same mant/rbit/sticky),
    # so clamp at exactly that point (the ladder bound in
    # shift_right_round is sized to it)
    u = jnp.minimum(sr + _I32(16 * pre), _I32(16 * (len(mag) + pre) + 1))
    # n_mant_chunks limbs suffice: the shifted value's MSB sits at bit
    # (mant_bits-1) (< 16*n_mant_chunks) and the round-up carry tops out
    # at exactly 2^mant_bits, still inside the same limbs — the old +1
    # spare limb cost a whole extra funnel output word
    mant, rbit, sticky = lb.shift_right_round(mag, u, n_mant_chunks,
                                              pre_zero_limbs=pre)
    # round to nearest even
    inc = (rbit == 1) & (sticky | ((mant[0] & _I32(1)) == 1))
    mant = lb.carry_propagate([mant[0] + inc.astype(_I32)] + list(mant[1:]))
    # mantissa overflow (2^mant_bits): renormalize
    ovf_chunk = (mant_bits // 16)
    ovf_bit = mant_bits % 16
    overflowed = (mant[ovf_chunk] >> ovf_bit) & _I32(1)
    # if overflowed, mantissa is exactly 2^mant_bits -> shift right by 1
    # (all lower bits zero), i.e. just clear and bump exponent
    mant[ovf_chunk] = mant[ovf_chunk] & _I32((1 << ovf_bit) - 1)
    # keep implicit-bit-stripped mantissa: clear bit (mant_bits-1)
    top_chunk = (mant_bits - 1) // 16
    top_bit = (mant_bits - 1) % 16
    eb_eff = jnp.where(eb <= 0, _I32(0), eb) + overflowed
    # after subnormal shift the implicit bit may be absent; stripping a zero
    # bit is harmless
    subnormal_now = eb_eff == 0
    mant[top_chunk] = jnp.where(
        subnormal_now, mant[top_chunk],
        mant[top_chunk] & _I32(~(1 << top_bit) & 0xFFFF))
    # subnormal rounding may carry into the exponent: if after rounding the
    # implicit bit appeared in a subnormal, eb becomes 1 with that bit
    # stripped — IEEE addition of bit patterns makes this automatic when we
    # assemble exp + mant as an integer. We emulate by detecting it:
    sub_carry = subnormal_now & (((mant[top_chunk] >> top_bit) & _I32(1)) == 1)
    eb_eff = eb_eff + sub_carry.astype(_I32)
    mant[top_chunk] = jnp.where(
        sub_carry, mant[top_chunk] & _I32(~(1 << top_bit) & 0xFFFF),
        mant[top_chunk])
    # overflow to inf
    is_inf = eb_eff >= _I32(emax_field)
    eb_eff = jnp.where(is_inf, _I32(emax_field), eb_eff)
    mant = [jnp.where(is_inf | is_zero, _I32(0), c) for c in mant]
    eb_eff = jnp.where(is_zero, _I32(0), eb_eff)
    return eb_eff, mant


def _assemble_f64(neg, eb, mant) -> F64Bits:
    lo = (mant[0] | (mant[1] << 16)).astype(_U32)
    hi = (mant[2] | ((mant[3] & _I32(0xF)) << 16) | (eb << 20)
          | (neg.astype(_I32) << 31)).astype(_U32)
    return F64Bits(hi, lo)


def _assemble_f32(neg, eb, mant) -> jax.Array:
    bits = (mant[0] | ((mant[1] & _I32(0x7F)) << 16) | (eb << 23)
            | (neg.astype(_I32) << 31)).astype(_U32)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def reconstruct(r: jax.Array, sft_a: jax.Array, sft_b: jax.Array,
                num_moduli: int, out_dtype: str, e_extra: int = 0):
    """CRT-reconstruct and inverse-scale the emulated GEMM result.

    r: (L, m, n) int32 canonical residues of the slice products.
    sft_a: (m, 1) int32; sft_b: (1, n) int32 (encode shifts).
    out_dtype: 'f64' -> F64Bits, 'f32' -> jnp.float32 array.
    e_extra: static exponent added to the inverse-scaling 2^-(sftA+sftB)
    — how a power-of-two alpha folds into the rounding for free (exact:
    the value is rounded ONCE at the folded exponent, strictly at least
    as accurate as a post-hoc multiply; the reference instead fuses alpha
    into its inverse-scaling kernels, inverse_scaling.hpp:269-820).
    """
    x = accumulate_weighted(r, num_moduli)
    return finalize(x, sft_a, sft_b, num_moduli, out_dtype, e_extra)


def finalize(x, sft_a: jax.Array, sft_b: jax.Array, num_moduli: int,
             out_dtype: str, e_extra: int = 0):
    """Mod-M centering + inverse scaling + rounding, from accumulated
    weighted limbs (see accumulate_weighted)."""
    mag, negf = _mod_m_centered(x, num_moduli)
    e_fix = _I32(e_extra) - (sft_a + sft_b)
    if out_dtype == "f64":
        eb, mant = _round_to_float(mag, negf, e_fix, 53)
        return _assemble_f64(negf, eb, mant)
    elif out_dtype == "f32":
        eb, mant = _round_to_float(mag, negf, e_fix, 24)
        return _assemble_f32(negf, eb, mant)
    else:
        raise ValueError(out_dtype)
