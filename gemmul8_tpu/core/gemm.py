"""GEMM-emulation orchestrator: encode -> slice int8 GEMMs -> mod-reduce ->
CRT reconstruct, for every real input/output dtype combination.

This is the JAX counterpart of the reference's gemm template
specializations (/root/reference/GEMMul8/src/gemmul8.cu:149-577): one
jittable function of the operands, composed of the four phases the reference
times separately. Mixed precision falls out of per-operand encode dispatch
(the reference templates the scaling kernels per operand type the same way,
gemmul8.cu:538-540).

Operands are canonical internal forms:
  - F64Bits (hi/lo uint32 arrays) for FP64 data
  - jnp.float32 arrays for FP32 data
Output: F64Bits ('f64' target) or float32 array ('f32' target).
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from .. import tables
from ..types import F64Bits
from . import encode as enc
from . import reconstruct as rec
from . import slicegemm as sg

Operand = Union[F64Bits, jax.Array]


def _is_f64(x: Operand) -> bool:
    return isinstance(x, F64Bits)


def _check_shapes(a: Operand, b: Operand):
    m, ka = a.shape
    kb, n = b.shape
    if ka != kb:
        raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
    if ka > tables.MAX_K:
        raise ValueError(
            f"k={ka} exceeds the int32-exactness bound 2^17"
            " — shard k (see gemmul8_tpu.parallel) or chunk the call")
    return m, ka, n


def encode_operand_fast(x: Operand, num_moduli: int, axis: int):
    if _is_f64(x):
        return enc.encode_fast_f64(x, num_moduli, axis)
    return enc.encode_fast_f32(x, num_moduli, axis)


def accurate_sfts(a: Operand, b: Operand, num_moduli: int):
    """Accurate-mode ('int8tc') joint shift selection: 7-bit round-up
    magnitudes, one extra int8 GEMM |A|x|B|, then per-row/col shifts from the
    product-magnitude estimate (reference scaling.hpp:3053-3136). Every
    reduction is a max, so the shifts do not depend on summation order."""
    if _is_f64(a):
        mag_a, emax_a = enc.mag7_f64(a, axis=1)
    else:
        mag_a, emax_a = enc.mag7_f32(a, axis=1)
    if _is_f64(b):
        mag_b, emax_b = enc.mag7_f64(b, axis=0)
    else:
        mag_b, emax_b = enc.mag7_f32(b, axis=0)
    s = jax.lax.dot_general(mag_a, mag_b, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    smax_a = jnp.max(s, axis=1, keepdims=True)
    smax_b = jnp.max(s, axis=0, keepdims=True)
    sft_a = enc.accurate_sft(smax_a, emax_a, num_moduli,
                             53 if _is_f64(a) else 24)
    sft_b = enc.accurate_sft(smax_b, emax_b, num_moduli,
                             53 if _is_f64(b) else 24)
    return sft_a, sft_b


def encode_operand_accurate(a: Operand, b: Operand, num_moduli: int):
    sft_a, sft_b = accurate_sfts(a, b, num_moduli)
    a8 = _encode_idx(a, sft_a, num_moduli, None)
    b8 = _encode_idx(b, sft_b, num_moduli, None)
    return a8, sft_a, b8, sft_b


def gemm_core(a: Operand, b: Operand, num_moduli: int, fastmode: bool,
              out_dtype: str, moduli_chunk: int | None = None,
              alpha_e: int = 0):
    """C = A @ B emulated. a: (m,k); b: (k,n). Returns F64Bits or f32.

    moduli_chunk: low-memory mode — materialize only `moduli_chunk` residue
    slices at a time (re-running the cheap encode pass per chunk) and fold
    each chunk's products into the CRT limb accumulator before the next is
    built. Capability parity with the reference's `memory-lt` branch
    (README.md:3); peak slice memory scales with the chunk, not with
    num_moduli.

    alpha_e: static exponent of a power-of-two alpha, folded into the
    reconstruct's inverse scaling (exact and free — the analog of the
    reference's alpha-fused inverse_scaling variants)."""
    _check_shapes(a, b)
    # named scopes label each phase's fusions in profiler traces
    with jax.named_scope("encode"):
        sft_a, sft_b = _select_sfts(a, b, num_moduli, fastmode)
    if moduli_chunk is None or moduli_chunk >= num_moduli:
        with jax.named_scope("encode"):
            a8 = _encode_idx(a, sft_a, num_moduli, None)
            b8 = _encode_idx(b, sft_b, num_moduli, None)
        with jax.named_scope("slice_gemm"):
            c32 = sg.slice_products(a8, b8)
        with jax.named_scope("mod_reduce"):
            r = sg.mod_reduce(c32, num_moduli)
        with jax.named_scope("reconstruct"):
            return rec.reconstruct(r, sft_a, sft_b, num_moduli, out_dtype,
                                   alpha_e)

    # ---- moduli-chunked schedule (shifts already selected above:
    # they are chunk-independent) ----
    from ..planner import ModuliSchedule

    sched = ModuliSchedule(num_moduli, moduli_chunk)
    acc = None
    for j0, width in sched.chunks():
        idx = tuple(range(j0, j0 + width))
        a8 = _encode_idx(a, sft_a, num_moduli, idx)
        b8 = _encode_idx(b, sft_b, num_moduli, idx)
        c32 = sg.slice_products(a8, b8)
        r = sg.mod_reduce(c32, num_moduli, idx)
        acc = rec.accumulate_weighted(r, num_moduli, idx, acc)
    return rec.finalize(acc, sft_a, sft_b, num_moduli, out_dtype, alpha_e)


def gemm_core_panels(a: Operand, b: Operand, num_moduli: int, fastmode: bool,
                     out_dtype: str, n_panel: int, alpha_e: int = 0):
    """Column-panel schedule for problems whose full slice tensors exceed
    device memory: A is encoded once; B is encoded, multiplied, and
    reconstructed one n-panel at a time, so peak residue memory scales with
    the panel width. In fast mode per-column B statistics are panel-local,
    so panels are independent and results are bit-identical to one-shot;
    accurate-mode shifts depend on B, so A is re-encoded per panel."""
    _check_shapes(a, b)
    n = b.shape[1]
    outs = []
    a8 = None
    sft_a = _fast_sft_only(a, num_moduli, axis=1) if fastmode else None
    for j0 in range(0, n, n_panel):
        bp = b[:, j0:j0 + n_panel] if not isinstance(b, F64Bits) else \
            F64Bits(b.hi[:, j0:j0 + n_panel], b.lo[:, j0:j0 + n_panel])
        if fastmode:
            sft_b = _fast_sft_only(bp, num_moduli, axis=0)
        else:
            sft_a, sft_b = accurate_sfts(a, bp, num_moduli)
            a8 = None
        if a8 is None:
            a8 = _encode_idx(a, sft_a, num_moduli, None)
        b8 = _encode_idx(bp, sft_b, num_moduli, None)
        c32 = sg.slice_products(a8, b8)
        r = sg.mod_reduce(c32, num_moduli)
        outs.append(rec.reconstruct(r, sft_a, sft_b, num_moduli, out_dtype,
                                    alpha_e))
    if out_dtype == "f64":
        return F64Bits(jnp.concatenate([o.hi for o in outs], axis=1),
                       jnp.concatenate([o.lo for o in outs], axis=1))
    return jnp.concatenate(outs, axis=1)


def _select_sfts(a: Operand, b: Operand, num_moduli: int, fastmode: bool):
    """Shift selection shared by the one-shot and moduli-chunked paths."""
    if fastmode:
        return (_fast_sft_only(a, num_moduli, axis=1),
                _fast_sft_only(b, num_moduli, axis=0))
    return accurate_sfts(a, b, num_moduli)


def _fast_sft_only(x: Operand, num_moduli: int, axis: int):
    if _is_f64(x):
        chunks, exp, sign, normal = enc._f64_fields(x.hi, x.lo)
        sft, _ = enc._fast_sft(chunks, exp, normal, axis, num_moduli, 53)
    else:
        bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32),
                                            jnp.uint32)
        chunks, exp, sign, normal = enc._f32_fields(bits)
        sft, _ = enc._fast_sft(chunks, exp, normal, axis, num_moduli, 24)
    return sft


def _encode_idx(x: Operand, sft, num_moduli: int, idx):
    if _is_f64(x):
        return enc.encode_accurate_f64(x, sft, num_moduli, idx)
    return enc.encode_accurate_f32(x, sft, num_moduli, idx)


def gemm_phases(a: Operand, b: Operand, num_moduli: int, fastmode: bool,
                 out_dtype: str):
    """Staged variant returning per-phase jitted callables for the
    reference's 4-part breakdown (gemmul8.cu:10-18): encode / int8 GEMMs /
    mod-reduce / reconstruct."""
    _check_shapes(a, b)

    @jax.jit
    def phase_encode(a, b):
        if fastmode:
            a8, sft_a = encode_operand_fast(a, num_moduli, axis=1)
            b8, sft_b = encode_operand_fast(b, num_moduli, axis=0)
        else:
            a8, sft_a, b8, sft_b = encode_operand_accurate(a, b, num_moduli)
        return a8, sft_a, b8, sft_b

    @jax.jit
    def phase_matmul(a8, b8):
        return sg.slice_products(a8, b8)

    @jax.jit
    def phase_mod(c32):
        return sg.mod_reduce(c32, num_moduli)

    @jax.jit
    def phase_reconstruct(r, sft_a, sft_b):
        return rec.reconstruct(r, sft_a, sft_b, num_moduli, out_dtype)

    return phase_encode, phase_matmul, phase_mod, phase_reconstruct
