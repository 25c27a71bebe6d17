"""Fast exact modular reduction by small constant moduli.

Integer division is slow on vector units; jnp's `%` lowers to a costly
sequence. These helpers compute x mod m exactly with a biased-down f32
quotient estimate plus conditional fixups — the equivalent of the
reference's Barrett `__mulhi(x, 2^32/m)` reduction
(GEMMul8 src/conv_32i_2_8u.hpp:25-56). Exactness argument
is in each function; fixup counts are conservative.
"""

from __future__ import annotations

import jax.numpy as jnp

_I32 = jnp.int32


def mod_u26(x, m: int, bound_bits: int = 26):
    """x mod m for 0 <= x < 2^bound_bits (<= 28), 2 <= m <= 256. Exact.

    bound_bits <= 26: f32(x) abs error <= 2, (1/m) rel error <= 2^-24 ->
    quotient estimate error < 0.07; biased down 0.25 the floor lies in
    {q-1, q}: one fixup. bound_bits 27/28: f32(x) abs error <= 8/16 and
    x/m * 2^-24 < 1.0 -> bias 1.0, estimate in {q-2..q}: two fixups."""
    if bound_bits <= 26:
        q = (x.astype(jnp.float32) * jnp.float32(1.0 / m)
             - jnp.float32(0.25)).astype(_I32)
        r = x - q * _I32(m)
        r = r - jnp.where(r >= _I32(m), _I32(m), _I32(0))
        return r
    assert bound_bits <= 28
    # the two-fixup budget needs x/m * 2^-24 + f32-cast error/m << 1:
    # at bound 28 the cast error alone is <= 16, so small m would leave an
    # unreduced remainder. Tie the contract to the proof (callers on this
    # branch use the odd moduli, all >= 173).
    assert m >= 16, f"bound_bits {bound_bits} requires m >= 16, got {m}"
    q = (x.astype(jnp.float32) * jnp.float32(1.0 / m)
         - jnp.float32(1.0)).astype(_I32)
    q = jnp.maximum(q, 0)
    r = x - q * _I32(m)
    for s in (2, 1):
        r = r - jnp.where(r >= _I32(s * m), _I32(s * m), _I32(0))
    return r


def mod_i32(x, m: int):
    """x mod m (canonical, in [0, m)) for any int32 x, 2 <= m <= 256. Exact.

    f32(x) abs error <= 128 -> quotient error <= 128/m + |x|/m * 2^-23 + 1
    < 7; biased down 8 the floored estimate lies in [q-15, q]: four
    halving fixups cover it."""
    q = jnp.floor(x.astype(jnp.float32) * jnp.float32(1.0 / m)
                  - jnp.float32(8.0)).astype(_I32)
    r = x - q * _I32(m)
    # r in [0, 16m): fix down by 8m, 4m, 2m, m
    for s in (8, 4, 2, 1):
        r = r - jnp.where(r >= _I32(s * m), _I32(s * m), _I32(0))
    return r
