"""Mutable-precision SGEMM on low-precision matrix units (cuMpSGEMM analog).

The reference suite includes cuMpSGEMM: SGEMM/
CGEMM on FP16/TF32 Tensor Cores with Ootomo-style error correction (TCEC),
exponent-statistics-driven automatic precision selection, and dynamic
scaling (README.md:1-57, src/exp_stats.cu, src/dynamic_scaling.cu).

Here the fast matrix-unit input format is bfloat16. Error-corrected f32
matmul = split each f32 operand into leading/residual bf16 parts and sum
the cross products ("bf16x3": hi*hi + hi*lo + lo*hi — the TCEC recipe with
bf16 instead of FP16; "bf16x6" adds the second-order terms for full-f32
grade). Because bf16 shares f32's exponent range there is no overflow
motivation for scaling, but the residual split loses bits when a tensor's
dynamic range is extreme — exp_stats drives the AUTO mode and the dynamic
scaling mode exactly like the reference's exponent histograms.

Modes (cf. cuMpSGEMM/include/cumpsgemm/detail/common.h:6-19):
  NATIVE  — XLA f32 dot (Precision.HIGHEST)
  BF16TC  — one bf16 matmul (TF32TC analog)
  BF16X3  — error-corrected 3-matmul split (FP16TCEC analog)
  BF16X6  — 6-term split (full f32 accuracy)
  SCALING — per-row/col power-of-2 scaling + BF16X3 (FP16TCEC_SCALING)
  AUTO    — exp_stats-driven choice between BF16TC / BF16X3 / NATIVE
"""

from __future__ import annotations

import enum
from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Mode(enum.Enum):
    NATIVE = "native"
    BF16TC = "bf16tc"
    BF16X3 = "bf16x3"
    BF16X6 = "bf16x6"
    SCALING = "scaling"
    AUTO = "auto"


class ExpStats(NamedTuple):
    """Exponent statistics of a tensor (reference exp_stats.cu:7-49):
    histogram over biased f32 exponent octaves, plus the fraction of
    nonzero elements more than `lose_threshold` octaves below the max
    (those lose residual-split precision)."""

    max_exp: jax.Array        # int32 biased exponent of amax
    lost_fraction: jax.Array  # f32 in [0, 1]
    total: jax.Array          # nonzero count


def exp_stats(x: jax.Array, lose_threshold: int = 16) -> ExpStats:
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    e = ((bits >> 23) & jnp.uint32(0xFF)).astype(jnp.int32)
    nz = e > 0
    emax = jnp.max(jnp.where(nz, e, 0))
    lost = jnp.sum((nz & (e < emax - lose_threshold)).astype(jnp.int32))
    total = jnp.maximum(jnp.sum(nz.astype(jnp.int32)), 1)
    return ExpStats(emax, lost.astype(jnp.float32) / total, total)


def _split_bf16(x: jax.Array):
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return hi, lo


def _dot(a, b):
    return jax.lax.dot_general(a, b, (((a.ndim - 1,), (b.ndim - 2,)),
                                      ((), ())),
                               preferred_element_type=jnp.float32)


def _bf16x3(a, b):
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    return _dot(ah, bh) + (_dot(ah, bl) + _dot(al, bh))


def _bf16x6(a, b):
    ah, al = _split_bf16(a)
    bh, bl = _split_bf16(b)
    a2 = (a - ah.astype(jnp.float32) - al.astype(jnp.float32)).astype(
        jnp.bfloat16)
    b2 = (b - bh.astype(jnp.float32) - bl.astype(jnp.float32)).astype(
        jnp.bfloat16)
    return (_dot(ah, bh)
            + (_dot(ah, bl) + _dot(al, bh))
            + (_dot(al, bl) + _dot(ah, b2) + _dot(a2, bh)))


def _scaled_bf16x3(a, b):
    """Dynamic scaling (reference dynamic_scaling.cu:7-44): scale rows of a
    / cols of b to near-1 magnitude by powers of two (exact), multiply,
    unscale. Protects the residual split from underflow at extreme
    magnitudes."""
    # clamp with the smallest NORMAL f32 (1e-38 is subnormal and flushes
    # to zero where denormals are off, sending log2 to -inf and poisoning
    # all-zero rows with 0 * inf = NaN)
    tiny = jnp.float32(jnp.finfo(jnp.float32).tiny)
    ea = jnp.floor(jnp.log2(jnp.maximum(
        jnp.max(jnp.abs(a), axis=-1, keepdims=True), tiny)))
    eb = jnp.floor(jnp.log2(jnp.maximum(
        jnp.max(jnp.abs(b), axis=-2, keepdims=True), tiny)))
    sa = jnp.exp2(-ea)
    sb = jnp.exp2(-eb)
    c = _bf16x3(a * sa, b * sb)
    # ea is (..., m, 1), eb is (..., 1, n): broadcasts to the (m, n) output.
    # Unscale with two factors — exp2(ea + eb) overflows f32 when
    # ea + eb > 127 even though each factor (and the product) is finite.
    return c * jnp.exp2(ea) * jnp.exp2(eb)


_CUSTOM_MX2X2 = True


def enable_custom_gemm_Mx2x2() -> None:
    """Route (m, 2) x (2, 2) GEMMs through the skinny elementwise path
    (default; the cuGEMM-Mx2x2 submodule analog — cuBLAS handles these
    degenerate shapes poorly; cuMpSGEMM/python/src/main.cpp:42)."""
    global _CUSTOM_MX2X2
    _CUSTOM_MX2X2 = True


def disable_custom_gemm_Mx2x2() -> None:
    global _CUSTOM_MX2X2
    _CUSTOM_MX2X2 = False


def gemm_Mx2x2(a: jax.Array, b: jax.Array):
    """GEMM-(2^p, 2, 2): a (..., m, 2) x b (..., 2, 2) as explicit
    broadcast-multiply-adds — a k=2, n=2 contraction wastes nearly all of
    a matrix unit's tile, so the elementwise form stands in for the
    reference's custom skinny kernels (cuGEMM-Mx2x2/README.md:1-8; real
    and complex, plain or strided-batch via leading batch dims)."""
    assert a.shape[-1] == 2 and b.shape[-2:] == (2, 2), (a.shape, b.shape)
    a0, a1 = a[..., 0:1], a[..., 1:2]

    def bcol(i, j):  # (..., 1, 1): broadcasts against a's (..., m, 1)
        return b[..., i:i + 1, j:j + 1]

    return jnp.concatenate(
        [a0 * bcol(0, 0) + a1 * bcol(1, 0),
         a0 * bcol(0, 1) + a1 * bcol(1, 1)], axis=-1)


def mp_gemm(a: jax.Array, b: jax.Array, mode: Mode = Mode.AUTO,
            auto_lost_threshold: float = 0.05):
    """Mutable-precision f32 GEMM. a (..., m, k) x b (..., k, n)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    if _CUSTOM_MX2X2 and a.shape[-1] == 2 and b.shape[-2:] == (2, 2):
        # f32 mult-adds round once each — at least the accuracy of
        # every mode (incl. SCALING's 2^s round trip), never worse
        return gemm_Mx2x2(a, b)
    if mode == Mode.NATIVE:
        return jax.lax.dot_general(
            a, b, (((a.ndim - 1,), (b.ndim - 2,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
    if mode == Mode.BF16TC:
        return _dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16))
    if mode == Mode.BF16X3:
        return _bf16x3(a, b)
    if mode == Mode.BF16X6:
        return _bf16x6(a, b)
    if mode == Mode.SCALING:
        return _scaled_bf16x3(a, b)
    if mode == Mode.AUTO:
        # device-side rule, no host sync (reference dynamic_launch.cu):
        # extreme dynamic range -> full-precision path, else corrected bf16
        sa = exp_stats(a)
        sb = exp_stats(b)
        bad = jnp.maximum(sa.lost_fraction, sb.lost_fraction)
        return jax.lax.cond(
            bad > auto_lost_threshold,
            lambda x, y: jax.lax.dot_general(
                x, y, (((x.ndim - 1,), (y.ndim - 2,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32),
            _bf16x3, a, b)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# Imperative exp_stats / dynamic-scaling surface (cuMpSGEMM parity:
# include/cumpsgemm/cumpsgemm.hpp:39-107 — exp_stats_ext / exp_max_ext
# buffer ids, get_exp_stats, thresholds, enable/disable, compute-mode
# level, scale_A/B/C). JAX arrays are immutable, so the scale_* calls
# return the scaled array instead of mutating in place — the documented
# deviation from the CUDA in-place API; buffer ids and stats behave the
# same.
# ---------------------------------------------------------------------------


class ExpStatsHandle:
    """Stats-buffer ring mirroring the cuMpSGEMM handle's exp_stats state."""

    def __init__(self, ring_size: int = 256):
        self.enabled = False
        self.ignore_threshold = 0.0
        self.underflow_threshold = 2.0 ** -15
        self.underflow_ratio_tolerance = 0.05
        self._ring_size = ring_size
        self._buffers: dict[int, tuple] = {}
        self._next_id = 1
        self._current_id = 0

    # -- params / toggles (cumpsgemm.hpp:57-66) --
    def set_exp_stats_params(self, ignore_threshold: float,
                             underflow_threshold: float,
                             underflow_ratio_tolerance: float) -> None:
        self.ignore_threshold = float(ignore_threshold)
        self.underflow_threshold = float(underflow_threshold)
        self.underflow_ratio_tolerance = float(underflow_ratio_tolerance)

    def enable_exp_stats(self) -> None:
        self.enabled = True

    def disable_exp_stats(self) -> None:
        self.enabled = False

    # -- stat collection (cumpsgemm.hpp:39-51) --
    def exp_stats_ext(self, x) -> int:
        """Count elements below the underflow threshold (ignoring those
        below ignore_threshold) and stash (lost, total, max|x|) in a new
        buffer; returns its id."""
        ax = jnp.abs(jnp.asarray(x, jnp.float32))
        considered = ax > jnp.float32(self.ignore_threshold)
        lost = jnp.sum(
            (considered & (ax < jnp.float32(self.underflow_threshold)))
            .astype(jnp.int32))
        total = jnp.sum(considered.astype(jnp.int32))
        amax = jnp.max(ax)
        bid = self._store((int(lost), int(total), float(amax)))
        return bid

    def exp_max_ext(self, x) -> int:
        ax = jnp.abs(jnp.asarray(x, jnp.float32))
        bid = self._store((0, int(jnp.size(x)), float(jnp.max(ax))))
        return bid

    def _store(self, rec) -> int:
        bid = self._next_id
        self._next_id += 1
        self._buffers[bid] = rec
        self._current_id = bid
        if len(self._buffers) > self._ring_size:
            self._buffers.pop(min(self._buffers))
        return bid

    # -- queries --
    def get_exp_stats(self, buffer_id: int) -> tuple:
        lost, total, _ = self._buffers[buffer_id]
        return lost, total

    def get_max_exp(self, buffer_id: int) -> float:
        return self._buffers[buffer_id][2]

    def get_current_exp_stats_buffer_id(self) -> int:
        return self._current_id

    def reset_exp_stats_buffer_id(self) -> None:
        self._current_id = 0

    def get_exp_stats_compute_mode_level(self, buffer_id: int) -> Mode:
        """AUTO-mode decision from a stats buffer (the reference returns
        FP16TCEC vs FP16TCEC_SCALING by underflow ratio)."""
        lost, total, _ = self._buffers[buffer_id]
        ratio = lost / max(total, 1)
        return (Mode.SCALING if ratio > self.underflow_ratio_tolerance
                else Mode.BF16X3)

    # -- dynamic scaling (cumpsgemm.hpp:72-107; functional, not in-place) --
    def _scale_factor(self, buffer_id: int):
        amax = self._buffers[buffer_id][2]
        if amax <= 0.0:
            return jnp.float32(1.0)
        return jnp.exp2(-jnp.floor(jnp.log2(jnp.float32(amax))))

    def scale_A(self, buffer_id: int, a):
        return jnp.asarray(a, jnp.float32) * self._scale_factor(buffer_id)

    def scale_B(self, buffer_id: int, b):
        return jnp.asarray(b, jnp.float32) * self._scale_factor(buffer_id)

    def scale_C(self, buffer_a_id: int, buffer_b_id: int, c):
        inv = (1.0 / self._scale_factor(buffer_a_id)
               / self._scale_factor(buffer_b_id))
        return jnp.asarray(c, jnp.float32) * inv

    def reset_scale_A(self, buffer_id: int, a):
        return jnp.asarray(a, jnp.float32) / self._scale_factor(buffer_id)

    reset_scale_B = reset_scale_A


_DEFAULT_HANDLE = ExpStatsHandle()


def default_handle() -> ExpStatsHandle:
    """Module-level handle (the hijack-control pattern: one process-wide
    handle unless the caller creates their own)."""
    return _DEFAULT_HANDLE


def mp_cgemm(a, b, mode: Mode = Mode.BF16X3):
    """Complex64 mutable-precision GEMM via 4 real mp_gemms."""
    a = jnp.asarray(a, jnp.complex64)
    b = jnp.asarray(b, jnp.complex64)
    ar, ai = jnp.real(a), jnp.imag(a)
    br, bi = jnp.real(b), jnp.imag(b)
    rr = mp_gemm(ar, br, mode)
    ii = mp_gemm(ai, bi, mode)
    ri = mp_gemm(ar, bi, mode)
    ir = mp_gemm(ai, br, mode)
    return jax.lax.complex(rr - ii, ri + ir)
