"""Per-modulus int8 slice products + modular reduction.

The error-free core of the scheme: for each modulus the centered residue
slices satisfy |a8|,|b8| <= 128, so with k <= 2^17 the int8 x int8 -> int32
dot products are exact, and C32 mod m_j recovers the residue of the true
integer product.  (Reference: the cublasGemmEx CUDA_R_8I loop at
GEMMul8 src/gemmul8.cu:259-275 and the Barrett uint8 reduction at
src/conv_32i_2_8u.hpp:25-56.)

The batched moduli axis maps to one batched s8 x s8 -> s32 dot_general,
which XLA hands to its int8 GEMM (cuBLASLt or its own emitter on a GPU);
the mod-reduce is elementwise work XLA fuses into the surrounding graph.
Being exact integer products, these results do not depend on the
backend's float matmul precision (a GPU's TF32 default never applies).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import tables
from .modmath import mod_i32

_I32 = jnp.int32


def slice_products(a8: jax.Array, b8: jax.Array) -> jax.Array:
    """(L, m, k) int8 x (L, k, n) int8 -> (L, m, n) int32, exact."""
    return jax.lax.dot_general(
        a8, b8,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )


def mod_reduce(c32: jax.Array, num_moduli: int, moduli_idx=None) -> jax.Array:
    """Canonical residues of the slice products: (L, m, n) int32 in [0, m_j).

    jnp floor-mod with positive divisor yields [0, m) for any sign. The
    modulus-256 slice is a pure bitmask."""
    if moduli_idx is None:
        moduli_idx = tuple(range(num_moduli))
    outs = []
    for jj, j in enumerate(moduli_idx):
        m = int(tables.MODULI[j])
        if m == 256:
            outs.append(c32[jj] & _I32(255))
        else:
            outs.append(mod_i32(c32[jj], m))
    return jnp.stack(outs, axis=0)


def int8_peak_probe(n: int = 8192, iters: int = 20) -> float:
    """Raw int8 GEMM throughput (TOP/s) of one plain n^3 s8 x s8 -> s32
    dot_general — the analog of the reference's INT8-GEMM ones-matrix row
    (testing/test_double.cu:287-309).

    One compiled warm-up call, then `iters` calls ended by one
    block_until_ready: the device runs them in order on one stream, so the
    last one finishing bounds them all, and nothing is added to the dot."""
    import time

    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.randint(ka, (n, n), -128, 128, dtype=jnp.int8)
    b = jax.random.randint(kb, (n, n), -128, 128, dtype=jnp.int8)
    step = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32))
    c = jax.block_until_ready(step(a, b))
    t0 = time.perf_counter()
    for _ in range(iters):
        c = step(a, b)
    jax.block_until_ready(c)
    dt = (time.perf_counter() - t0) / iters
    return 2 * n ** 3 / dt / 1e12
