"""Ozaki Scheme I baseline (ozIMMU-EF-style) for the comparison harness.

The reference benches GEMMul8 against RIKEN's ozIMMU_EF (Ozaki scheme I:
exponent-block splitting of FP64 into `num_split` int8 slices, slice-pair
int8 GEMMs, error-free accumulation — ozIMMU_EF src/split.cu +
gemm.cu:340-461). This re-implementation exists so
our harness can produce the same comparison rows (BASELINE.md §1
ozIMMU_EF-8/-9).

Design: FP64 operands are split bitwise into b=7-bit signed slices aligned
at the per-row/col max exponent; all slice pairs with s1+s2 < num_split
run as one batched int8 GEMM; the int32 pair products are accumulated
EXACTLY into a signed multi-limb fixed-point register (each diagonal
d = s1+s2 shifted by (num_split-1-d)*b bits) — the integer version of
the reference's group-wise error-free f64 accumulation — and rounded once
to f64. Error comes only from the slice truncation: ~2^(-7*num_split)
relative to the row/col max, crossing native DGEMM accuracy at ~9 slices
like the reference baseline.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..core import encode as enc
from ..core import limbs as lb
from ..core.reconstruct import _assemble_f64, _round_to_float
from ..types import F64Bits

_I32 = jnp.int32

BITS_PER_SLICE = 7  # |slice| < 2^7 -> pair products < 2^14, k <= 2^17 safe


def _split_slices(bits: F64Bits, num_split: int, axis: int):
    """Split each element into num_split signed b-bit slices aligned at the
    row/col max exponent. Returns (slices (S, m, k) int8, emax int32)."""
    chunks, exp, sign, normal = enc._f64_fields(bits.hi, bits.lo)
    emax = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
    b = BITS_PER_SLICE
    out = []
    neg = sign == 1
    mask = (1 << b) - 1
    for s in range(num_split):
        # slice s covers bits [53-(s+1)b, 53-sb) of the emax-aligned value;
        # u may go negative for deep slices of near-max elements (window
        # extends below the mantissa LSB) -> partial left placement
        u = (emax - exp) + _I32(53 - (s + 1) * b)
        d = enc._funnel_shift_right(chunks, jnp.clip(u, 0, 63))
        ul = jnp.clip(-u, 0, b)
        v = ((d[0] & (_I32(mask) >> ul)) << ul) & _I32(mask)
        v = jnp.where(neg, -v, v)
        v = jnp.where(normal, v, _I32(0))
        out.append(v.astype(jnp.int8))
    return jnp.stack(out, 0), emax


def ozimmu_gemm(a: F64Bits, b: F64Bits, num_split: int = 8):
    """Emulated DGEMM via Ozaki scheme I with num_split slices.

    Slice pairs with s1+s2 < num_split (the reference's gemm_pair_config
    triangle) are evaluated BY DIAGONAL: every pair on diagonal d = s1+s2
    shares one bit offset, so the whole diagonal collapses into a single
    int8 dot_general contracting (slice, k) jointly — exact in int32 while
    group_slices * k * 2^14 < 2^31. Slices per group mirror the
    reference's `lim_accum` error-free accumulation batching
    (ozIMMU_EF/src/gemm.cu:390-453: lim = 2^(31-2*bits-ceil(log2 k))).
    This keeps the graph at ~num_split products + scatters instead of
    num_split^2/2 — the unrolled per-pair graph exceeded the remote
    compiler's 2 GiB serialized-HLO cap at 8192^3 (VERDICT r1 item 3)."""
    from .. import tables

    k = a.shape[1]
    if k > tables.MAX_K:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound "
            f"2^17 (slice-pair dot products would wrap int32)")
    bb = BITS_PER_SLICE
    a8, emax_a = _split_slices(a, num_split, axis=1)
    b8, emax_b = _split_slices(b, num_split, axis=0)
    # slices per exact-int32 diagonal group: products are < 2^14 each, so
    # g*k*2^14 <= 2^31 requires g <= 2^17/k
    g = max(1, (1 << 17) // k)

    # Exact signed fixed-point accumulation: diagonal d contributes at bit
    # offset (num_split-1-d)*b above the frame LSB. Each int32 group
    # product is scattered byte-wise into 16-bit limb accumulators
    # (per-limb partial sums stay < 78 groups * 2^23 < 2^31); positive and
    # negative parts are accumulated separately and subtracted at the end.
    max_bit = (num_split - 1) * bb + 32
    nl = max_bit // 16 + 2
    shape = (a.shape[0], b.shape[1])
    pos = [jnp.zeros(shape, _I32) for _ in range(nl)]
    negacc = [jnp.zeros(shape, _I32) for _ in range(nl)]
    for d in range(num_split):
        off = (num_split - 1 - d) * bb
        for g0 in range(0, d + 1, g):
            g1 = min(g0 + g, d + 1)  # pairs (s1, d-s1), s1 in [g0, g1)
            lhs = a8[g0:g1]
            rhs = jnp.flip(b8[d - g1 + 1: d - g0 + 1], 0)
            p = jax.lax.dot_general(lhs, rhs, (((0, 2), (0, 1)), ((), ())),
                                    preferred_element_type=jnp.int32)
            mag = jnp.abs(p)
            isneg = p < 0
            posmag = jnp.where(isneg, jnp.zeros_like(mag), mag)
            negmag = jnp.where(isneg, mag, jnp.zeros_like(mag))
            for ci in range(4):
                wl, rl = divmod(off + 8 * ci, 16)
                pos[wl] = pos[wl] + (((posmag >> (8 * ci)) & _I32(0xFF))
                                     << rl)
                negacc[wl] = negacc[wl] + (((negmag >> (8 * ci))
                                            & _I32(0xFF)) << rl)
    pos = lb.carry_propagate(pos)
    negacc = lb.carry_propagate(negacc)
    # total = pos - neg (signed): pick the larger magnitude
    diff, borrow = lb.sub(pos, negacc)
    diff2 = lb.const_minus([0] * nl, diff)  # two's complement negation
    is_negative = borrow < 0
    mag = lb.select(is_negative, diff2, diff)
    e_fix = (emax_a - _I32(1075)) + (emax_b - _I32(1075)) + _I32(106) \
        - _I32((num_split + 1) * bb)
    eb, mant = _round_to_float(mag, is_negative, e_fix, 53)
    return _assemble_f64(is_negative, eb, mant)


def mantissa_loss_stats(bits: F64Bits, num_split: int, axis: int):
    """Average number of mantissa bits falling below the slice window —
    the statistic ozIMMU's auto mode thresholds on
    (OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD, ozIMMU_EF/src/config.cu:4-146
    and split.cu mantissa-loss counters)."""
    chunks, exp, sign, normal = enc._f64_fields(bits.hi, bits.lo)
    emax = jnp.max(jnp.where(normal, exp, _I32(0)), axis=axis, keepdims=True)
    # bits of the element below the split window [emax - num_split*b, emax)
    depth = (emax - exp) + _I32(53 - num_split * BITS_PER_SLICE)
    lost = jnp.clip(depth, 0, 53).astype(jnp.float32)
    lost = jnp.where(normal, lost, 0.0)
    cnt = jnp.maximum(jnp.sum(normal.astype(_I32)), 1)
    return jnp.sum(lost) / cnt.astype(jnp.float32)


def auto_num_split(a: F64Bits, b: F64Bits, threshold: float | None = None,
                   candidates=range(3, 17)) -> int:
    """ozIMMU `fp64_int8_auto` analog: the smallest slice count whose
    average mantissa loss (both operands) is below `threshold` bits
    (default: the GEMMUL8_AUTO_AVG_MANTISSA_LOSS_THRESHOLD env knob,
    mirroring OZIMMU_AUTO_AVG_MANTISSA_LOSS_THRESHOLD)."""
    if threshold is None:
        from .. import config as cfg
        threshold = cfg.get_config().auto_avg_mantissa_loss_threshold
    for s in candidates:
        la = float(mantissa_loss_stats(a, s, axis=1))
        lb_ = float(mantissa_loss_stats(b, s, axis=0))
        if (la + lb_) / 2 <= threshold:
            return s
    return max(candidates)


@lru_cache(maxsize=None)
def _jit_ozimmu(num_split):
    return jax.jit(lambda a, b: ozimmu_gemm(a, b, num_split))


def ozimmu_gemm_np(a: np.ndarray, b: np.ndarray, num_split: int = 8):
    from ..types import bits_to_f64, f64_to_bits

    out = _jit_ozimmu(num_split)(f64_to_bits(a), f64_to_bits(b))
    return bits_to_f64(out, to_numpy=True)


def ozimmu_zgemm(a_re: F64Bits, a_im: F64Bits, b_re: F64Bits, b_im: F64Bits,
                 num_split: int = 8):
    """Complex DGEMM via Ozaki-I (the reference hijacks cublasZgemm_v2 the
    same way, ozIMMU_EF/src/cublas.cu:300): four real slice-GEMMs combined
    as (RR - II) + i(RI + IR), each error-free in limb space."""
    rr = ozimmu_gemm(a_re, b_re, num_split)
    ii = ozimmu_gemm(a_im, b_im, num_split)
    ri = ozimmu_gemm(a_re, b_im, num_split)
    ir = ozimmu_gemm(a_im, b_re, num_split)
    from ..core import softfloat as sf

    re = sf.sub(rr, ii)
    im = sf.add(ri, ir)
    return re, im


@lru_cache(maxsize=None)
def _jit_ozimmu_z(num_split):
    return jax.jit(lambda ar, ai, br, bi: ozimmu_zgemm(ar, ai, br, bi,
                                                       num_split))


def ozimmu_zgemm_np(a: np.ndarray, b: np.ndarray, num_split: int = 8):
    from ..types import bits_to_f64, f64_to_bits

    re, im = _jit_ozimmu_z(num_split)(
        f64_to_bits(a.real), f64_to_bits(a.imag),
        f64_to_bits(b.real), f64_to_bits(b.imag))
    return bits_to_f64(re, to_numpy=True) + 1j * bits_to_f64(im,
                                                             to_numpy=True)
