"""Public types for the Ozaki-II GEMM emulation engine.

Mirrors the capability surface of the reference public header
(GEMMul8 include/gemmul8.hpp:7-22: computeType_t, workSize,
gemm<TA,TB,TC>), re-expressed for JAX.

FP64 data travels through the compute path as explicit bit patterns
(`F64Bits`: hi/lo uint32 arrays): every encode / reconstruct step is exact
int32 work, so the result does not depend on the device's float64 unit and
is bit-identical across backends. Native float64 arrays are accepted and
returned wherever JAX runs with x64 enabled (`backend_has_f64`); the
bits <-> f64 conversion is a bitcast on the device.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class ComputeType(enum.Enum):
    """Complex-multiplication strategy (real inputs ignore this).

    Parity with reference include/gemmul8.hpp:7-12."""

    REAL_DEFAULT = 0
    COMPLEX_BIG_MATRIX_ENCODE = 1   # one doubled-size int8 GEMM per modulus
    COMPLEX_CLASSIC_MULT = 2        # four int8 GEMMs per modulus
    COMPLEX_KARATSUBA_MULT = 3      # three int8 GEMMs per modulus


class F64Bits(NamedTuple):
    """An FP64 array as raw IEEE-754 bit patterns: hi word (sign|exp|mant-hi),
    lo word (mant-lo). Both uint32, same shape."""

    hi: jax.Array
    lo: jax.Array

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    def transpose(self, *axes) -> "F64Bits":
        return F64Bits(self.hi.transpose(*axes), self.lo.transpose(*axes))

    @property
    def T(self) -> "F64Bits":
        return F64Bits(self.hi.T, self.lo.T)

    def __getitem__(self, idx) -> "F64Bits":  # type: ignore[override]
        return F64Bits(self.hi[idx], self.lo[idx])


class C64Bits(NamedTuple):
    """A complex128 array as two F64Bits (real, imag)."""

    re: F64Bits
    im: F64Bits

    @property
    def shape(self):
        return self.re.hi.shape


def backend_has_f64() -> bool:
    """Whether float64 device arrays exist: x64 enabled on a CPU or GPU
    backend. Float64 operands then come back as float64 results."""
    return (bool(jax.config.jax_enable_x64)
            and jax.default_backend() in ("cpu", "gpu"))


def f64_to_bits(x) -> F64Bits:
    """Convert an f64 array (numpy or jax) to F64Bits.

    With float64 device arrays (`backend_has_f64`) the array is moved to
    the device once and split there by a bitcast; otherwise numpy input is
    split on the host by a free view."""
    if isinstance(x, F64Bits):
        return x
    if isinstance(x, np.ndarray) and backend_has_f64():
        x = jnp.asarray(np.asarray(x, np.float64))
    if isinstance(x, np.ndarray):
        u = np.ascontiguousarray(x, dtype=np.float64).view(np.uint32)
        u = u.reshape(x.shape + (2,))
        # little-endian: word 0 = low, word 1 = high
        return F64Bits(jnp.asarray(u[..., 1]), jnp.asarray(u[..., 0]))
    return _split_f64(x)


@jax.jit
def _split_f64(x):
    # one dispatch instead of one per eager op
    u = jax.lax.bitcast_convert_type(x.astype(jnp.float64), jnp.uint32)
    return F64Bits(u[..., 1], u[..., 0])


@jax.jit
def _join_f64(hi, lo):
    return jax.lax.bitcast_convert_type(jnp.stack([lo, hi], axis=-1),
                                        jnp.float64)


def as_numpy(x) -> np.ndarray:
    """Result of gemm() as a host ndarray regardless of domain: F64Bits
    becomes float64 (np.asarray on the NamedTuple would silently stack the
    raw hi/lo words into a (2, m, n) uint32 array); everything else passes
    through np.asarray."""
    if isinstance(x, F64Bits):
        return bits_to_f64(x, to_numpy=True)
    return np.asarray(x)


def bits_to_f64(b: F64Bits, to_numpy: bool = False):
    """Inverse of f64_to_bits: a device bitcast when x64 is enabled.
    Without x64 a device f64 array cannot exist, so the conversion happens
    on the host and returns numpy in that case."""
    if to_numpy or not jax.config.jax_enable_x64:
        hi = np.asarray(b.hi, dtype=np.uint32)
        lo = np.asarray(b.lo, dtype=np.uint32)
        u = np.stack([lo, hi], axis=-1)
        return np.ascontiguousarray(u).view(np.float64).reshape(hi.shape)
    return _join_f64(b.hi, b.lo)


def f32_to_bits(x) -> jax.Array:
    """f32 array -> uint32 bit patterns (exact on all backends)."""
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32), jnp.uint32)


def bits_to_f32(u) -> jax.Array:
    return jax.lax.bitcast_convert_type(u.astype(jnp.uint32), jnp.float32)
