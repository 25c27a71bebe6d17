"""Smoke run of the emulated GEMM on the GPU, through the public entry points.

    python chip_smoke.py [--seed S]     # one card: phases 1-7 below
    python chip_smoke.py --four-cards   # gemm_sharded on a 2x2 mesh only

Phases on one card (phi = 0.5 operands from --seed, one process, x64 on):

  1. DGEMM emulation 8192^3, fast, 14 moduli, via g8.gemm on float64
     operands A and B = A^T (bench.py's protocol): float64 out,
     bit-identical to the F64Bits-operand call, gate tiles within 1e-8 of
     the dd oracle; beside it cuBLAS native DGEMM.
  2. The same in accurate mode.
  3. SGEMM emulation 8192^3, fast, 8 moduli: median relerr <= 2e-7.
  4. Complex128 4096^3, three strategies, fast-14; one complex64 call.
  5. Schedules and epilogue at 4096^3 bit-identical to one-shot (moduli
     chunks, column panels, gemm_batched); C -= A.B at 8192 x 1024 x 8192
     against the CPU backend.
  6. Card against CPU backend at 1024^3, bit for bit.
  7. Int8 GEMM rate of a plain 8192^3 dot, and what the slice products
     compiled to.

Every product on the emulation path is int8 x int8 -> int32, which is exact,
so the GPU's TF32 default for float32 matmuls never touches it. The float
references here set precision=HIGHEST.

Any failed check raises; then the script exits non-zero and prints no
result line. Without a GPU it exits 1 before any phase. The last line of
standard output is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

GATE_TILE = 256


class SmokeFailure(AssertionError):
    """A phase's check failed."""


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Reporter:
    """Prints phase lines; every time or rate carries the card's name and
    power limit, since a card held below its limit runs slower."""

    def __init__(self, card: str):
        self.card = card

    def info(self, msg: str) -> None:
        print(msg, flush=True)

    def timed(self, label: str, seconds: float, flops: float | None = None,
              extra: str = "") -> None:
        rate = f", {flops / seconds / 1e12:.2f} TFLOP/s" if flops else ""
        self.info(f"  {label}: {seconds * 1e3:.3f} ms{rate}{extra} "
                  f"[{self.card}]")


def median_time(fn, *args, reps: int = 5):
    """Warm up once, then the median of `reps` calls that each end in
    block_until_ready. Returns (seconds, last result)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def gate_tiles(n_rows: int, n_cols: int):
    t = min(GATE_TILE, n_rows, n_cols)
    return t, [(0, 0), (n_rows // 2, n_cols - t), (n_rows - t, n_cols - t)]


def gate_relerr(out, a: np.ndarray, b: np.ndarray, refs: dict) -> float:
    """Max relerr of `out` (real f64) on the gate tiles vs the dd oracle.
    `refs` caches the oracle tiles for reuse across calls."""
    from gemmul8_tpu.bench.native import dd_gemm, relerr_vs_dd

    t, tiles = gate_tiles(a.shape[0], b.shape[1])
    worst = 0.0
    for r, c in tiles:
        if (r, c) not in refs:
            refs[r, c] = dd_gemm(a[r:r + t], np.ascontiguousarray(
                b[:, c:c + t]))
        got = np.asarray(out[r:r + t, c:c + t], np.float64)
        worst = max(worst, relerr_vs_dd(got, *refs[r, c])[0])
    return worst


def gate_relerr_complex(out, a: np.ndarray, b: np.ndarray,
                        refs: dict) -> float:
    """Max elementwise |z - z_ref| / |z_ref| on the gate tiles, z_ref from
    four real dd GEMMs combined in dd. `refs` caches the oracle tiles."""
    from gemmul8_tpu.bench.native import dd_gemm

    t, tiles = gate_tiles(a.shape[0], b.shape[1])
    worst = 0.0
    for r, c in tiles:
        if (r, c) not in refs:
            ar = np.ascontiguousarray(a.real[r:r + t])
            ai = np.ascontiguousarray(a.imag[r:r + t])
            br = np.ascontiguousarray(b.real[:, c:c + t])
            bi = np.ascontiguousarray(b.imag[:, c:c + t])
            rr, ii, ri, ir = (dd_gemm(x, y) for x, y in (
                (ar, br), (ai, bi), (ar, bi), (ai, br)))
            refs[r, c] = ((rr[0] - ii[0]) + (rr[1] - ii[1]),
                          (ri[0] + ir[0]) + (ri[1] + ir[1]))
        ref_re, ref_im = refs[r, c]
        got = np.asarray(out[r:r + t, c:c + t], np.complex128)
        d = np.hypot(got.real - ref_re, got.imag - ref_im)
        worst = max(worst, float(np.max(d / np.hypot(ref_re, ref_im))))
    return worst


def bits_equal(x, y) -> bool:
    """Bit-for-bit equality of two float64 (or complex128) arrays."""
    import jax
    import jax.numpy as jnp

    x, y = jnp.asarray(x), jnp.asarray(y)
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if jnp.iscomplexobj(x):
        return bits_equal(jnp.real(x), jnp.real(y)) and \
            bits_equal(jnp.imag(x), jnp.imag(y))
    u = jnp.uint64 if x.dtype == jnp.float64 else jnp.uint32
    return bool(jnp.all(jax.lax.bitcast_convert_type(x, u)
                        == jax.lax.bitcast_convert_type(y, u)))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_dgemm(rep: Reporter, n: int, seed: int, fastmode: bool,
                refs: dict, with_native: bool):
    """Phases 1 and 2: emulated DGEMM n^3, 14 moduli, via g8.gemm."""
    import jax
    import jax.numpy as jnp

    import gemmul8_tpu as g8
    from gemmul8_tpu import api
    from gemmul8_tpu.bench.matrices import phi_matrix

    mode = "fast" if fastmode else "accurate"
    rep.info(f"[dgemm {mode}-14] {n}^3, B = A^T")
    # bench.py's protocol: B = A^T. Zero-mean independent operands put a
    # few outputs per tile ~6 orders below the median |c| by cancellation,
    # where a max relerr measures that cancellation, not the emulation.
    a = phi_matrix(n, n, 0.5, seed)
    b = np.ascontiguousarray(a.T)
    out_np = g8.gemm(a, b, num_moduli=14, fastmode=fastmode)
    check(isinstance(out_np, jax.Array) and out_np.dtype == jnp.float64,
          f"float64 in must give a float64 array out, got {type(out_np)}")
    out_bits = g8.gemm(g8.f64_to_bits(a), g8.f64_to_bits(b), num_moduli=14,
                       fastmode=fastmode)
    check(isinstance(out_bits, g8.F64Bits), "F64Bits in must give F64Bits")
    check(bits_equal(out_np, g8.bits_to_f64(out_bits)),
          "float64-operand and F64Bits-operand results differ")
    rel = gate_relerr(out_np, a, b, refs)
    rep.info(f"  gate-tile max relerr vs dd: {rel:.3e}")
    check(rel < 1e-8, f"gate-tile relerr {rel:.3e} >= 1e-8")

    ad, bd = jnp.asarray(a), jnp.asarray(b)
    del out_np, out_bits
    ca, cb = g8.f64_to_bits(ad), g8.f64_to_bits(bd)
    compiled = api._jit_core(14, fastmode, "f64").lower(ca, cb).compile()
    rep.info(f"  memory_analysis: {compiled.memory_analysis()}")
    del ca, cb
    dt, out = median_time(
        lambda x, y: g8.gemm(x, y, num_moduli=14, fastmode=fastmode), ad, bd)
    rep.timed(f"emulated DGEMM {mode}-14", dt, 2.0 * n ** 3)
    rep.info(f"  peak_bytes_in_use: {peak_bytes()}")
    check(bool(jnp.all(jnp.isfinite(out))), "non-finite output")
    if with_native:
        dtn, nat = median_time(lambda x, y: jnp.matmul(
            x, y, precision=jax.lax.Precision.HIGHEST), ad, bd)
        reln = gate_relerr(nat, a, b, refs)
        rep.timed("native DGEMM (cuBLAS, HIGHEST)", dtn, 2.0 * n ** 3,
                  f", gate-tile max relerr {reln:.3e}")
    return compiled.as_text()


def phase_sgemm(rep: Reporter, n: int, seed: int):
    """Phase 3: SGEMM emulation n^3, fast, 8 moduli, f32 in and out."""
    import jax
    import jax.numpy as jnp

    import gemmul8_tpu as g8
    from gemmul8_tpu.bench.matrices import phi_matrix

    rep.info(f"[sgemm fast-8] {n}^3")
    a = jnp.asarray(phi_matrix(n, n, 0.5, seed + 2), jnp.float32)
    b = jnp.asarray(phi_matrix(n, n, 0.5, seed + 3), jnp.float32)
    dt, out = median_time(lambda x, y: g8.gemm(x, y, num_moduli=8), a, b)
    check(out.dtype == jnp.float32, f"f32 in must give f32 out: {out.dtype}")
    rep.timed("emulated SGEMM fast-8", dt, 2.0 * n ** 3)
    ref = jnp.matmul(a.astype(jnp.float64), b.astype(jnp.float64),
                     precision=jax.lax.Precision.HIGHEST)
    den = jnp.where(ref == 0, 1.0, jnp.abs(ref))
    med = float(jnp.median(jnp.abs(out.astype(jnp.float64) - ref) / den))
    rep.info(f"  median relerr vs float64 product: {med:.3e}")
    check(med <= 2e-7, f"SGEMM median relerr {med:.3e} > 2e-7")
    dtn, _ = median_time(lambda x, y: jnp.matmul(
        x, y, precision=jax.lax.Precision.HIGHEST), a, b)
    rep.timed("native SGEMM (HIGHEST)", dtn, 2.0 * n ** 3)


def phase_complex(rep: Reporter, n: int, seed: int):
    """Phase 4: complex128 n^3 under all three strategies, fast-14, and one
    complex64 call that must return a device complex64 array."""
    import jax
    import jax.numpy as jnp

    import gemmul8_tpu as g8
    from gemmul8_tpu.bench.matrices import phi_matrix

    rep.info(f"[complex128 fast-14] {n}^3")
    a = phi_matrix(n, n, 0.5, seed + 4) + 1j * phi_matrix(n, n, 0.5, seed + 5)
    b = phi_matrix(n, n, 0.5, seed + 6) + 1j * phi_matrix(n, n, 0.5, seed + 7)
    ad, bd = jnp.asarray(a), jnp.asarray(b)
    refs = {}
    for ct in (g8.ComputeType.COMPLEX_BIG_MATRIX_ENCODE,
               g8.ComputeType.COMPLEX_CLASSIC_MULT,
               g8.ComputeType.COMPLEX_KARATSUBA_MULT):
        dt, out = median_time(lambda x, y: g8.gemm(
            x, y, num_moduli=14, compute_type=ct), ad, bd)
        check(out.dtype == jnp.complex128,
              f"complex128 in must give complex128 out: {out.dtype}")
        rel = gate_relerr_complex(out, a, b, refs)
        rep.timed(f"{ct.name}", dt, 8.0 * n ** 3,
                  f" (complex flops), gate-tile max relerr {rel:.3e}")
        check(rel < 1e-8, f"{ct.name} relerr {rel:.3e} >= 1e-8")
    a64, b64 = ad.astype(jnp.complex64), bd.astype(jnp.complex64)
    out64 = g8.gemm(a64, b64, num_moduli=8)
    check(isinstance(out64, jax.Array) and out64.dtype == jnp.complex64,
          f"complex64 must come back as a device complex64 array, got "
          f"{type(out64)} {getattr(out64, 'dtype', None)}")
    ref = jnp.matmul(a64.astype(jnp.complex128), b64.astype(jnp.complex128),
                     precision=jax.lax.Precision.HIGHEST)
    med = float(jnp.median(jnp.abs(out64 - ref) / jnp.abs(ref)))
    rep.info(f"  complex64 fast-8: device {out64.dtype} array, median "
             f"relerr {med:.3e}")
    check(med <= 2e-7, f"complex64 median relerr {med:.3e} > 2e-7")


def phase_schedules(rep: Reporter, n: int, seed: int, m_epi: int, k_epi: int,
                    m_cpu: int):
    """Phase 5: moduli-chunked, column-panel and batched schedules are
    bit-identical to one-shot at n^3; C -= A.B at (m_epi, k_epi, m_epi)
    matches the CPU backend on its leading (m_cpu, m_cpu) block."""
    import jax.numpy as jnp

    import gemmul8_tpu as g8
    from gemmul8_tpu.bench.matrices import phi_matrix

    rep.info(f"[schedules] {n}^3 fast-14")
    a = jnp.asarray(phi_matrix(n, n, 0.5, seed + 8))
    b = jnp.asarray(phi_matrix(n, n, 0.5, seed + 9))
    dt, one = median_time(lambda x, y: g8.gemm(x, y), a, b)
    rep.timed("one-shot", dt, 2.0 * n ** 3)
    for label, kw in (("moduli_chunk=4", dict(moduli_chunk=4)),
                      (f"n_panel={n // 4}", dict(n_panel=n // 4))):
        dt, out = median_time(lambda x, y: g8.gemm(x, y, **kw), a, b)
        check(bits_equal(out, one), f"{label} differs from one-shot")
        rep.timed(f"{label} (bit-identical)", dt, 2.0 * n ** 3)
    dt, outb = median_time(g8.gemm_batched, jnp.stack([a, b]),
                           jnp.stack([b, a]))
    check(bits_equal(outb[0], one), "gemm_batched[0] differs from gemm")
    check(bits_equal(outb[1], g8.gemm(b, a)),
          "gemm_batched[1] differs from gemm")
    rep.timed("gemm_batched x2 (bit-identical)", dt, 4.0 * n ** 3)
    del outb, one

    rep.info(f"[C -= A.B] m=n={m_epi}, k={k_epi}")
    a = phi_matrix(m_epi, k_epi, 0.5, seed + 10)
    b = phi_matrix(k_epi, m_epi, 0.5, seed + 11)
    c = phi_matrix(m_epi, m_epi, 0.5, seed + 12)
    ad, bd, cd = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    dt, out = median_time(lambda x, y, z: g8.gemm(
        x, y, alpha=-1.0, beta=1.0, c=z), ad, bd, cd)
    rep.timed("alpha=-1 beta=1", dt, 2.0 * m_epi * m_epi * k_epi)
    on_cpu = _on_cpu(lambda: g8.gemm(a[:m_cpu], b[:, :m_cpu], alpha=-1.0,
                                     beta=1.0, c=c[:m_cpu, :m_cpu]))
    _compare_fast(rep, out[:m_cpu, :m_cpu], on_cpu, a[:m_cpu],
                  b[:, :m_cpu], 14, "C -= A.B vs CPU")


def _on_cpu(fn):
    """Run `fn` with the CPU backend as the default device; result as
    numpy."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return np.asarray(fn())


def _fast_shifts(x: np.ndarray, num_moduli: int, axis: int) -> np.ndarray:
    import jax

    from gemmul8_tpu.core import gemm as gg
    from gemmul8_tpu.types import f64_to_bits

    return np.asarray(jax.jit(lambda v: gg._fast_sft_only(
        v, num_moduli, axis))(f64_to_bits(x)))


def _compare_fast(rep: Reporter, got, want: np.ndarray, a: np.ndarray,
                  b: np.ndarray, num_moduli: int, label: str):
    """Fast-mode card-vs-CPU comparison. Shifts come from an f32 norm
    whose summation order differs between backends, so a row's (col's)
    shift may differ by 1 where the norm lands within rounding noise of
    its floor (core/encode.py sft_floor_frac). Every element outside such
    rows and columns must be bit-identical; the rest stays within the
    gate bound, normwise."""
    import jax

    from gemmul8_tpu.core import encode as enc
    from gemmul8_tpu.types import f64_to_bits

    got = np.asarray(got)
    diffs = []
    for x, axis in ((a, 1), (b, 0)):
        s_g = _fast_shifts(x, num_moduli, axis)
        with jax.default_device(jax.devices("cpu")[0]):
            s_c = _fast_shifts(x, num_moduli, axis)
        diff = (s_g != s_c).ravel()
        check(np.all(np.abs(s_g - s_c) <= 1),
              f"{label}: shifts differ by more than 1")
        if diff.any():
            bits = f64_to_bits(x)
            _, nrm2, _, k = enc._fast_stats_multi(
                [enc._f64_fields(bits.hi, bits.lo)], axis, 53)
            frac = np.asarray(enc.sft_floor_frac(nrm2, k, num_moduli))
            check(frac.ravel()[diff].max() < 1e-4,
                  f"{label}: shift differs away from a floor boundary")
        diffs.append(diff)
    rows, cols = diffs
    same = ~(rows[:, None] | cols[None, :])
    g_bits = got.view(np.uint64)
    w_bits = np.asarray(want).view(np.uint64)
    check(np.array_equal(g_bits[same], w_bits[same]),
          f"{label}: elements with equal shifts are not bit-identical")
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    rep.info(f"  {label}: {int(rows.sum())} rows and {int(cols.sum())} "
             f"cols with a shift differing by 1; elsewhere bit-identical; "
             f"normwise relerr between the two {rel:.3e}")
    check(rel < 1e-8, f"{label}: normwise relerr {rel:.3e} >= 1e-8")


def phase_card_vs_cpu(rep: Reporter, n: int, seed: int):
    """Phase 6: the card's result against the CPU backend's, at n^3."""
    import gemmul8_tpu as g8
    from gemmul8_tpu.bench.matrices import phi_matrix

    rep.info(f"[card vs CPU] {n}^3")
    a = phi_matrix(n, n, 0.5, seed + 13)
    b = phi_matrix(n, n, 0.5, seed + 14)
    # accurate mode: shifts come from maxes, which do not depend on order
    got = np.asarray(g8.gemm(a, b, num_moduli=14, fastmode=False))
    want = _on_cpu(lambda: g8.gemm(a, b, num_moduli=14, fastmode=False))
    check(np.array_equal(got.view(np.uint64), want.view(np.uint64)),
          "accurate-14: card and CPU results differ")
    rep.info("  accurate-14: bit-identical")
    got = g8.gemm(a, b, num_moduli=20)
    want = _on_cpu(lambda: g8.gemm(a, b, num_moduli=20))
    _compare_fast(rep, got, want, a, b, 20, "fast-20")


_HLO_DEF = (r"^\s*(?:ROOT )?%?([\w.\-]+) = (\([^)]*\)|[a-z]\w*\[\S*) "
            r"([\w\-]+)\((.*)$")


def slice_gemm_impl(hlo_text: str) -> list[str]:
    """What carries each int8 (s8) dot in compiled HLO text: the
    custom-call target (a cuBLAS/cuBLASLt call), a fusion's backend kind
    (e.g. a Triton GEMM), or a plain `dot` the backend emits itself."""
    import re

    types, found = {}, set()
    for line in hlo_text.splitlines():
        m = re.match(_HLO_DEF, line)
        if not m:
            continue
        name, rtype, op, rest = m.groups()
        types[name] = rtype
        operands = re.findall(r"%([\w.\-]+)", rest.split("),")[0])
        if not any(types.get(o, "").startswith("s8[") for o in operands):
            continue
        target = re.search(r'custom_call_target="([^"]+)"', rest)
        kind = re.search(r'"kind":"([^"]+)"', rest)
        if op == "custom-call" and target:
            found.add(f"custom-call {target.group(1)}")
        elif op == "fusion" and kind and "gemm" in kind.group(1):
            found.add(f"fusion {kind.group(1)}")
        elif op == "dot":
            found.add("dot")
    return sorted(found)


def s8_relayouts(hlo_text: str) -> list[str]:
    """Instructions that transpose or copy an int8 tensor — XLA's sign
    that a GEMM operand was not in the layout the library wants."""
    import re

    out = []
    for line in hlo_text.splitlines():
        m = re.match(_HLO_DEF, line)
        if m and m.group(2).startswith("s8[") and (
                m.group(3) in ("transpose", "copy")
                or "transpose" in m.group(1)):
            out.append(f"{m.group(1)} = {m.group(2)} {m.group(3)}")
    return out


def phase_int8(rep: Reporter, n: int, hlo_text: str):
    """Phase 7: plain int8 GEMM rate, and what the slice GEMM became."""
    import jax

    from gemmul8_tpu.bench.timing import device_peaks
    from gemmul8_tpu.core import slicegemm as sg

    rep.info(f"[int8 GEMM] {n}^3 s8 x s8 -> s32")
    tops = sg.int8_peak_probe(n)
    rep.timed("plain int8 dot_general", 2.0 * n ** 3 / tops / 1e12,
              extra=f", {tops:.1f} TOP/s")
    kind = jax.devices()[0].device_kind
    if jax.devices()[0].platform == "gpu":
        peak = device_peaks(kind)["int8_tops"]
        rep.info(f"  share of the {kind} data-sheet int8 peak "
                 f"({peak:.0f} TOP/s): {tops / peak:.3f}")
    impl = slice_gemm_impl(hlo_text)
    rep.info(f"  slice products (batched s8 dot) compiled to: {impl}")
    rep.info(f"  s8 transposes/copies in the compiled step: "
             f"{s8_relayouts(hlo_text)}")
    check(impl, "no int8 dot found in the compiled step")


# --------------------------------------------------------------------------
# four cards
# --------------------------------------------------------------------------

def phase_sharded(rep: Reporter, n: int, n_cplx: int, seed: int):
    """gemm_sharded on a 2x2 mesh of four cards: accurate mode bit-identical
    to the single-card gemm on device 0, fast mode within the gate-tile dd
    bound, one Karatsuba complex128 call."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import gemmul8_tpu as g8
    from gemmul8_tpu.bench.matrices import phi_matrix
    from gemmul8_tpu.parallel import distributed as dist
    from gemmul8_tpu.types import bits_to_f64

    mesh = dist.make_mesh(4)
    rep.info(f"[gemm_sharded] mesh {dict(mesh.shape)}, {n}^3 f64, 14 "
             "moduli, B = A^T")
    a = phi_matrix(n, n, 0.5, seed + 15)
    b = np.ascontiguousarray(a.T)
    spec = NamedSharding(mesh, P("x", "y")), NamedSharding(mesh, P("y", "x"))
    A, B = (jax.device_put(g8.f64_to_bits(x), g8.F64Bits(s_, s_))
            for x, s_ in zip((a, b), spec))
    refs = {}

    def per_card():
        return [peak_bytes(d) for d in mesh.devices.ravel()]

    dt, out = median_time(lambda x, y: dist.gemm_sharded(
        x, y, mesh, num_moduli=14), A, B)
    rel = gate_relerr(bits_to_f64(out, to_numpy=True), a, b, refs)
    rep.timed("sharded fast-14", dt, 2.0 * n ** 3,
              f", gate-tile max relerr {rel:.3e}")
    check(rel < 1e-8, f"sharded fast relerr {rel:.3e} >= 1e-8")
    dt, out = median_time(lambda x, y: dist.gemm_sharded(
        x, y, mesh, num_moduli=14, fastmode=False), A, B)
    rep.timed("sharded accurate-14", dt, 2.0 * n ** 3)
    rep.info(f"  peak_bytes_in_use per card: {per_card()}")
    sharded = bits_to_f64(out, to_numpy=True)
    del out
    dev0 = jax.devices()[0]
    del A, B
    single = g8.gemm(a, b, num_moduli=14, fastmode=False)   # on dev0
    check(np.array_equal(np.asarray(single).view(np.uint64),
                         sharded.view(np.uint64)),
          "sharded accurate result differs from single-card gemm")
    rep.info(f"  accurate-14: sharded == single card on {dev0} "
             "(bit-identical)")
    del single

    rep.info(f"[gemm_sharded_complex] Karatsuba complex128 {n_cplx}^3")
    za = (phi_matrix(n_cplx, n_cplx, 0.5, seed + 17)
          + 1j * phi_matrix(n_cplx, n_cplx, 0.5, seed + 18))
    zb = (phi_matrix(n_cplx, n_cplx, 0.5, seed + 19)
          + 1j * phi_matrix(n_cplx, n_cplx, 0.5, seed + 20))
    dt, (zre, zim) = median_time(lambda x, y: dist.gemm_sharded_complex(
        x, y, mesh, num_moduli=14,
        compute_type=g8.ComputeType.COMPLEX_KARATSUBA_MULT), za, zb)
    z = (bits_to_f64(zre, to_numpy=True)
         + 1j * bits_to_f64(zim, to_numpy=True))
    rel = gate_relerr_complex(z, za, zb, {})
    rep.timed("sharded Karatsuba", dt, 8.0 * n_cplx ** 3,
              f" (complex flops), gate-tile max relerr {rel:.3e}")
    check(rel < 1e-8, f"sharded complex relerr {rel:.3e} >= 1e-8")
    rep.info(f"  peak_bytes_in_use per card: {per_card()}")


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only gemm_sharded on a 2x2 mesh of 4 cards")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (jax.devices()[0].platform="
              f"{dev.platform!r})", file=sys.stderr)
        return 1
    from gemmul8_tpu.bench.timing import card_info
    from gemmul8_tpu.config import enable_compile_cache

    rep = Reporter(card_info())
    rep.info(f"card (name, power.limit): {rep.card}")
    rep.info(f"jax {jax.__version__}; devices: {jax.devices()}")
    rep.info(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    if args.four_cards:
        if len(jax.devices()) != 4:
            print(f"chip_smoke: --four-cards needs 4 cards, found "
                  f"{len(jax.devices())}", file=sys.stderr)
            return 1
        phase_sharded(rep, 16384, 8192, args.seed)
    else:
        refs = {}
        hlo = phase_dgemm(rep, 8192, args.seed, True, refs, with_native=True)
        phase_dgemm(rep, 8192, args.seed, False, refs, with_native=False)
        phase_sgemm(rep, 8192, args.seed)
        phase_complex(rep, 4096, args.seed)
        phase_schedules(rep, 4096, args.seed, 8192, 1024, 1024)
        phase_card_vs_cpu(rep, 1024, args.seed)
        phase_int8(rep, 8192, hlo)
    rep.info(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
