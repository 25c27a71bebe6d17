"""Headline benchmark: emulated DGEMM TFLOP/s at m=n=k=8192, num_moduli=14,
fast mode, on one GPU (BASELINE.json metric). Prints one JSON line.

vs_baseline normalizes against the reference's GH200 OS2-fast-14 row
(72.13 TFLOP/s, BASELINE.md §1) scaled by the ratio of the int8 GEMM rate
measured in this run to GH200's int8 probe (1575 TOP/s): an
equal-quality implementation on this card would score
72.13 * probe / 1575.
"""

import json
import sys

import numpy as np

N = 8192
NUM_MODULI = 14
GH200_OS2_FAST_14_TFLOPS = 72.13
GH200_INT8_PROBE_TOPS = 1575.0


def main():
    import jax
    import jax.numpy as jnp

    from gemmul8_tpu.bench.matrices import phi_matrix
    from gemmul8_tpu.bench.native import dd_gemm, relerr_vs_dd
    from gemmul8_tpu.bench.timing import card_info, chained_time, require_gpu
    from gemmul8_tpu.config import enable_compile_cache
    from gemmul8_tpu.core import gemm as gg
    from gemmul8_tpu.core import slicegemm as sg
    from gemmul8_tpu.types import F64Bits, bits_to_f64, f64_to_bits

    require_gpu()
    enable_compile_cache()
    card = card_info()
    print(f"[bench] card: {card}", file=sys.stderr)

    a = phi_matrix(N, N, 0.5, seed=0)
    A = f64_to_bits(a)
    B = f64_to_bits(a.T.copy())

    def run(x, y_hi, y_lo, s_prev):
        # fold the previous checksum into one mantissa LSB of B's first row
        # inside the jitted graph: iterations form a serial dependency
        # chain no caching or reordering layer can collapse. y_lo is
        # donated and threaded through, so the update aliases in place.
        y_lo = y_lo.at[0, 0].set(y_lo[0, 0] ^ (s_prev & jnp.uint32(1)))
        o = gg.gemm_core(x, F64Bits(y_hi, y_lo), NUM_MODULI, True, "f64")
        # checksum over a strided sample: depends on the whole output
        # while itself costing ~nothing
        return o, jnp.sum(o.hi[::64, ::64] ^ o.lo[::64, ::64]), y_lo

    f = jax.jit(run, donate_argnums=(2,))
    dt, (out, _, _) = chained_time(
        lambda st: f(A, B.hi, st[2], st[1]),
        (None, jnp.uint32(0), jnp.array(B.lo)), 20)
    tflops = 2 * N ** 3 / dt / 1e12

    # accuracy on three 256x256 gate tiles vs the dd oracle (a plain f64
    # reference is itself rounding noise on the near-zero zero-mean sums
    # of a@a.T, which would inflate the max relerr by orders of magnitude)
    relerr = 0.0
    for r, c in [(0, 0), (N // 2, N - 256), (N - 256, N - 256)]:
        got = bits_to_f64(F64Bits(out.hi[r:r + 256, c:c + 256],
                                  out.lo[r:r + 256, c:c + 256]),
                          to_numpy=True)
        ref_hi, ref_lo = dd_gemm(a[r:r + 256],
                                 np.ascontiguousarray(a.T[:, c:c + 256]))
        relerr = max(relerr, relerr_vs_dd(got, ref_hi, ref_lo)[0])
    if not relerr < 1e-8:
        raise SystemExit(f"[bench] accuracy gate failed: relerr {relerr:.3e}")

    probe = sg.int8_peak_probe(N)
    baseline_equiv = GH200_OS2_FAST_14_TFLOPS * probe / GH200_INT8_PROBE_TOPS
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": f"emulated DGEMM TFLOP/s ({N}^3, {NUM_MODULI} moduli, "
                  f"fast, 1 card; max relerr vs dd ref {relerr:.2e})",
        "value": tflops,
        "unit": "TFLOP/s",
        "vs_baseline": tflops / baseline_equiv,
        "int8_probe_tops": probe,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
