"""Exact constant tables for Ozaki Scheme II (CRT over int8 residue GEMMs).

Everything here is derived from first principles with exact Python integer
arithmetic — moduli products, CRT reconstruction weights, Barrett constants,
power-of-two residues, and the shift-selection thresholds for fast
("vecnorm") and accurate ("int8tc") encode modes.

Reference behavior being matched (not copied): the moduli set and the
threshold formulas documented for GEMMul8 src/table.hpp
(moduli at table.hpp:27-48, thresholds at table.hpp:141-191, CRT weights at
table.hpp:195-826).  Our representation is different: instead of the
reference's double / double-double weight tables we keep arbitrary-precision
integers and decompose them into int32 limbs for exact elementwise math, plus
float64 / double-float views for the floating-point reconstruction path.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# The 20 pairwise-coprime moduli: 256 = 2^8 (free residue via int8 wraparound)
# plus the 19 largest odd numbers below 256 that keep the set coprime.
MODULI: tuple[int, ...] = (
    256, 255, 253, 251, 247, 241, 239, 233, 229, 227,
    223, 217, 211, 199, 197, 193, 191, 181, 179, 173,
)

MAX_MODULI = len(MODULI)  # 20
# k is bounded so that int8 x int8 dot products of length k fit in int32:
# |residue| <= 128 -> |product| <= 2^14; k <= 2^17 -> |sum| <= 2^31.
MAX_K = 1 << 17


def _check_pairwise_coprime() -> None:
    for i in range(len(MODULI)):
        for j in range(i + 1, len(MODULI)):
            assert math.gcd(MODULI[i], MODULI[j]) == 1, (MODULI[i], MODULI[j])


_check_pairwise_coprime()


@functools.cache
def big_m(num_moduli: int) -> int:
    """M = prod(moduli[:num_moduli]) as an exact Python int."""
    assert 2 <= num_moduli <= MAX_MODULI
    m = 1
    for v in MODULI[:num_moduli]:
        m *= v
    return m


@functools.cache
def crt_weights(num_moduli: int) -> tuple[int, ...]:
    """CRT reconstruction weights w_j = N_j * (M / m_j) with
    N_j = (M/m_j)^{-1} mod m_j, so that for residues r_j in [0, m_j):
        X == sum_j w_j * r_j  (mod M).
    Exact integers, each in [0, M)."""
    mm = big_m(num_moduli)
    out = []
    for j in range(num_moduli):
        mj = MODULI[j]
        mdiv = mm // mj
        nj = pow(mdiv % mj, -1, mj)
        out.append((nj * mdiv) % mm)
    return tuple(out)


# ---------------------------------------------------------------------------
# Shift-selection thresholds.
#
# fast mode keeps per-element magnitudes near 2^T_fast so that, with the
# 0.51*log2(norm^2) Cauchy-Schwarz guard, |sum_k a_k b_k| < M/2 is guaranteed.
# accurate mode can afford a tighter bound (T_accu = T_fast + 1) because the
# extra |A|*|B| int8 product gives an actual per-output magnitude estimate.
# (cf. reference table.hpp:141-191: vecnorm log2M = floor(log2(M-1)/2 - 1.5),
# int8tc log2M = floor(log2(M-1)/2 - 0.5).)
# ---------------------------------------------------------------------------

@functools.cache
def log2_big_m(num_moduli: int) -> float:
    mm = big_m(num_moduli)
    # exact-ish log2 of a big int
    return math.log2(mm)


@functools.cache
def threshold_fast(num_moduli: int) -> int:
    mm = big_m(num_moduli)
    return int(math.floor(_log2_bigint(mm - 1) / 2.0 - 1.5))


@functools.cache
def threshold_accurate(num_moduli: int) -> int:
    mm = big_m(num_moduli)
    return int(math.floor(_log2_bigint(mm - 1) / 2.0 - 0.5))


def _log2_bigint(x: int) -> float:
    """log2 of a big positive int without overflow, ~1e-15 relative error."""
    nbits = x.bit_length()
    if nbits <= 53:
        return math.log2(x)
    top = x >> (nbits - 53)
    return math.log2(top) + (nbits - 53)


# ---------------------------------------------------------------------------
# Limb decompositions (for the exact integer CRT reconstruction).
#
# We represent big integers in base 2^LIMB_BITS with int32 limbs.  With
# LIMB_BITS = 16: weight limbs < 2^16, residues <= 255, so each partial
# product < 2^24 and a sum over <= 20 moduli stays < 2^29 — safely inside
# int32 without carries until one final propagation.
# ---------------------------------------------------------------------------

LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS


@functools.cache
def num_limbs(num_moduli: int) -> int:
    """Limbs needed for values up to (255 * num_moduli * M): the raw CRT
    accumulation before mod-M reduction."""
    maxval = 255 * num_moduli * big_m(num_moduli)
    return (maxval.bit_length() + LIMB_BITS - 1) // LIMB_BITS


def to_limbs(x: int, n: int) -> list[int]:
    assert x >= 0
    out = [(x >> (LIMB_BITS * i)) & (LIMB_BASE - 1) for i in range(n)]
    assert x >> (LIMB_BITS * n) == 0, "limb overflow"
    return out


@functools.cache
def crt_weight_limbs(num_moduli: int) -> np.ndarray:
    """(num_moduli, num_limbs) int32 array of weight limbs."""
    n = num_limbs(num_moduli)
    w = crt_weights(num_moduli)
    return np.array([to_limbs(wj, n) for wj in w], dtype=np.int32)


@functools.cache
def big_m_limbs(num_moduli: int) -> np.ndarray:
    n = num_limbs(num_moduli)
    return np.array(to_limbs(big_m(num_moduli), n), dtype=np.int32)


def validate_crt(num_moduli: int, trials: int = 200, seed: int = 0) -> None:
    """Self-check: reconstruct random integers in (-M/2, M/2) from residues."""
    import random

    rng = random.Random(seed)
    mm = big_m(num_moduli)
    w = crt_weights(num_moduli)
    for _ in range(trials):
        x = rng.randrange(-(mm // 2) + 1, mm // 2)
        residues = [x % MODULI[j] for j in range(num_moduli)]
        acc = sum(w[j] * residues[j] for j in range(num_moduli)) % mm
        if acc > mm // 2:
            acc -= mm
        assert acc == x, (x, acc)


if __name__ == "__main__":
    for L in range(2, MAX_MODULI + 1):
        validate_crt(L, trials=50)
        print(
            f"L={L:2d} log2M={log2_big_m(L):7.2f} T_fast={threshold_fast(L):3d} "
            f"T_accu={threshold_accurate(L):3d} limbs={num_limbs(L)}"
        )
    print("CRT tables OK")
