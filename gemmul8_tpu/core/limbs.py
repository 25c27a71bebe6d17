"""Multi-limb integer arithmetic on int32 arrays (16-bit limbs).

The substitute for the f64 / double-double arithmetic the reference uses in
CRT reconstruction (GEMMul8 src/inverse_scaling.hpp:35-262): all values are
little-endian lists of int32 arrays each holding 16 bits, so every
operation is exact elementwise integer math.

Conventions: limbs may temporarily exceed 16 bits (redundant representation)
until `carry_propagate` is called; canonical limbs are in [0, 0xFFFF].
Signed intermediate limbs are fine — carry propagation uses arithmetic
shifts, which implement floor division by 2^16 for negative values too.
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp

_I32 = jnp.int32
_MASK = 0xFFFF


def carry_propagate(limbs: Sequence[jax.Array]) -> List[jax.Array]:
    """Normalize limbs into [0, 0xFFFF] each, propagating carries/borrows.
    The final carry is dropped (caller must size the limb count so it is 0,
    or use `sub` which returns the borrow)."""
    out = []
    c = jnp.zeros_like(limbs[0])
    for x in limbs:
        t = x + c
        out.append(t & _I32(_MASK))
        c = t >> 16  # arithmetic shift = floor division (handles negatives)
    return out


def sub(a: Sequence[jax.Array], b: Sequence[jax.Array]):
    """a - b limbwise with borrow propagation. Returns (limbs, borrow) where
    borrow is 0 if a >= b else -1 (a, b canonical, same length)."""
    out = []
    c = jnp.zeros_like(a[0])
    for xa, xb in zip(a, b):
        t = xa - xb + c
        out.append(t & _I32(_MASK))
        c = t >> 16
    return out, c


def select(cond: jax.Array, a: Sequence[jax.Array], b: Sequence[jax.Array]):
    """Elementwise limb select: cond ? a : b."""
    return [jnp.where(cond, xa, xb) for xa, xb in zip(a, b)]


def scale_const_sub(a: Sequence[jax.Array], t: jax.Array,
                    const_limbs: Sequence[int]) -> List[jax.Array]:
    """a - t * C for a small nonnegative elementwise multiplier t (< 2^13)
    and a compile-time constant C given as python ints. Result canonical
    (caller guarantees a - t*C fits the limb count and is >= -few*C)."""
    out = []
    c = jnp.zeros_like(a[0])
    for xa, cl in zip(a, const_limbs):
        prod = t * _I32(int(cl)) if cl else jnp.zeros_like(t)
        v = xa - prod + c
        out.append(v & _I32(_MASK))
        c = v >> 16
    return out, c


def sub_const(a: Sequence[jax.Array], const_limbs: Sequence[int]):
    """a - C limbwise vs a compile-time constant. Returns (limbs, borrow):
    borrow == 0 iff a >= C (limbs then canonical), else -1."""
    out = []
    c = jnp.zeros_like(a[0])
    for xa, cl in zip(a, const_limbs):
        t = xa - _I32(int(cl)) + c
        out.append(t & _I32(_MASK))
        c = t >> 16
    return out, c


def sub_const_borrow(a: Sequence[jax.Array],
                     const_limbs: Sequence[int]) -> jax.Array:
    """Borrow of a - C only (0 iff a >= C, else -1): the comparison chain
    without materializing the difference limbs — one mask+append per limb
    cheaper than sub_const when only the ordering is needed (the mod-M
    half test)."""
    c = jnp.zeros_like(a[0])
    for xa, cl in zip(a, const_limbs):
        c = (xa - _I32(int(cl)) + c) >> 16
    return c


def const_minus(const_limbs: Sequence[int], a: Sequence[jax.Array]):
    """C - a (elementwise; caller guarantees C >= a)."""
    out = []
    c = jnp.zeros_like(a[0])
    for xa, cl in zip(a, const_limbs):
        v = _I32(int(cl)) - xa + c
        out.append(v & _I32(_MASK))
        c = v >> 16
    return out


def shift_right(limbs: Sequence[jax.Array], u: jax.Array,
                n_out: int) -> List[jax.Array]:
    """Dynamic right shift by u (elementwise int32,
    0 <= u <= 16*len + 1 — the ladder is sized to that bound; clamp
    larger shifts to it, the outputs are identical beyond it),
    keeping the lowest n_out output limbs. Canonical input limbs.
    Thin wrapper over shift_right_round (one packed funnel-shift
    implementation to maintain)."""
    return shift_right_round(limbs, u, n_out)[0]


def shift_right_round(limbs: Sequence[jax.Array], u: jax.Array,
                      n_out: int, pre_zero_limbs: int = 0):
    """shift_right plus the IEEE rounding inputs in one packed pass:
    returns (shifted n_out limbs, round_bit, sticky) where round_bit is
    bit (u-1) of the value (0 when u == 0) and sticky is whether any bit
    below (u-1) is set. Shares the word packing the three separate calls
    (shift_right, a 1-limb shift for the round bit, dropped_nonzero)
    would each redo.

    pre_zero_limbs (even, static) logically prepends that many zero limbs
    below the value, i.e. the shift operates on value * 2^(16*pre).  The
    zero limbs are compile-time constants: funnel ladder entries where
    both the candidate and the accumulator are known-zero fold away, and
    the sticky mask skips them entirely — this is how the reconstruct
    rounding keeps its shift amount nonnegative (u' = sr + 16*pre >= 0)
    WITHOUT a second dynamic left-shift funnel for the sr < 0 branch."""
    n = len(limbs)
    _U = jnp.uint32
    assert pre_zero_limbs % 2 == 0, "pre-shift must be word-aligned"
    pw = pre_zero_limbs // 2
    nw_real = (n + 1) // 2
    words = []
    for i in range(nw_real):
        w = limbs[2 * i].astype(_U)
        if 2 * i + 1 < n:
            w = w | (limbs[2 * i + 1].astype(_U) << 16)
        words.append(w)
    ntot = n + pre_zero_limbs
    nw_out = (n_out + 1) // 2
    # the ladder needs to cover word shifts only up to "every bit below
    # u": callers clamp u <= 16*ntot + 1 (any larger u produces identical
    # outputs — zero mant, zero round bit, sticky = value-nonzero), so
    # ws <= (16*ntot + 1) >> 5. The old (16*(ntot+1))//32 + 1 bound
    # emitted 3-4 provably-dead select rungs per output word.
    max_ws = ((16 * ntot + 1) >> 5) + 1
    ws = u >> 5
    b = (u & _I32(31)).astype(_U)
    zero = jnp.zeros_like(words[0])
    # None marks a known-zero word (below the pre-shift or above the top)
    padded = [None] * pw + words + [None] * (max_ws + nw_out + 2)

    def at(i):
        return zero if padded[i] is None else padded[i]

    out_words = []
    for i in range(nw_out):
        sw = padded[i]
        sw1 = padded[i + 1]
        for wv in range(1, max_ws + 1):
            if padded[i + wv] is None and sw is None:
                pass  # selecting zero over zero: fold
            else:
                sw = jnp.where(ws == wv, at(i + wv),
                               zero if sw is None else sw)
            if padded[i + wv + 1] is None and sw1 is None:
                pass
            else:
                sw1 = jnp.where(ws == wv, at(i + wv + 1),
                                zero if sw1 is None else sw1)
        swv = zero if sw is None else sw
        sw1v = zero if sw1 is None else sw1
        out_words.append((swv >> b) | ((sw1v << (_U(31) - b)) << 1))
    out = []
    for j in range(n_out):
        w = out_words[j // 2]
        w = (w >> 16) if (j % 2) else w
        out.append(w.astype(_I32) & _I32(_MASK))
    # round bit: bit (u-1); select its word, then its bit
    up = jnp.maximum(u - 1, 0)
    wsp = up >> 5
    bp = (up & _I32(31)).astype(_U)
    rw = padded[0]
    for wv in range(1, max_ws + 1):
        if padded[wv] is None and rw is None:
            pass
        else:
            rw = jnp.where(wsp == wv, at(wv), zero if rw is None else rw)
    rwv = zero if rw is None else rw
    rbit = jnp.where(u > 0, ((rwv >> bp) & _U(1)).astype(_I32), _I32(0))
    # sticky: any bit below position up. Word (up>>5) contributes its low
    # (up&31) bits — and rwv IS that word, already selected for the round
    # bit, so a mask on it covers the partial word; every real word
    # strictly below contributes entirely (one threshold compare each).
    # Zero pre-words contribute nothing and are skipped by construction.
    sticky = (rwv & ((_U(1) << bp) - _U(1))) != 0
    for i, w in enumerate(words):
        sticky = sticky | ((w != 0) & (up >= _I32(32 * (i + pw + 1))))
    return out, rbit, sticky


def dropped_nonzero(limbs: Sequence[jax.Array], u: jax.Array) -> jax.Array:
    """Whether any of the low u bits are nonzero ('sticky')."""
    sticky = jnp.zeros_like(limbs[0], dtype=jnp.bool_)
    for i, c in enumerate(limbs):
        nbits = jnp.clip(u - 16 * i, 0, 16)
        mask = (_I32(1) << nbits) - _I32(1)
        sticky = sticky | ((c & mask) != 0)
    return sticky


def msb_position(limbs: Sequence[jax.Array]) -> jax.Array:
    """Bit position of the most significant set bit (value >= 0; returns -1
    for zero). lax.clz on each canonical 16-bit limb: per limb the scan is
    clz + compare + select, vs ~6 ops for an f32-exponent trick.
    Exact for any int32 limb value (no rounding involved)."""
    p = jnp.full_like(limbs[0], -1)
    for i, c in enumerate(limbs):
        # value msb = 31 - clz; position in the multi-limb value adds 16*i
        p = jnp.where(c > 0, _I32(16 * i + 31) - jax.lax.clz(c), p)
    return p
