"""One isolated emulated-DGEMM call under the profiler, with its device
time per kernel.

Equivalent of the reference's profile_one_call.cu (testing/
profile_one_call.cu:5-9): an 8192^3 fast-mode 14-moduli `g8.gemm` call,
repeated `--iters` times inside a jax.profiler trace written to
`--trace-dir`. The device plane of the trace is then reduced to the summed
device time per kernel, each labelled with the phase (the named scope
`encode` / `slice_gemm` / `mod_reduce` / `reconstruct` of core/gemm.py)
its HLO op came from. CUDA command buffers are off in this process, so
that each kernel's trace event names its op.

    python examples/profile_one_call.py --trace-dir chiprun_out/trace
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import collections
import glob
import time

PHASES = ("encode", "slice_gemm", "mod_reduce", "reconstruct")


def kernel_times(xplane_path: str):
    """{(line, kernel name, phase): [total device ns, count]} over every
    device plane of the trace. A kernel's phase is the first of PHASES in
    the op_name its trace event carries (its `name` stat), or '-'."""
    import jax

    data = jax.profiler.ProfileData.from_file(xplane_path)
    out = collections.defaultdict(lambda: [0.0, 0])
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                op_name = str(dict(ev.stats).get("name", "")) + "/"
                phase = next((p for p in PHASES if f"/{p}/" in op_name), "-")
                acc = out[(line.name, ev.name, phase)]
                acc[0] += ev.duration_ns
                acc[1] += 1
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=8192)
    p.add_argument("--moduli", type=int, default=14)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace-dir", required=True,
                   help="write the jax.profiler trace here")
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args()

    # XLA's CUDA command buffers hide which HLO op each kernel ran; with
    # them off every kernel's trace event names its op and scope
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    import gemmul8_tpu as g8
    from gemmul8_tpu.bench.matrices import phi_matrix
    from gemmul8_tpu.config import enable_compile_cache

    enable_compile_cache()
    n = args.n
    a = jnp.asarray(phi_matrix(n, n, 0.5, seed=0))
    b = jnp.asarray(phi_matrix(n, n, 0.5, seed=1))

    def call():
        return g8.gemm(a, b, num_moduli=args.moduli)

    jax.block_until_ready(call())          # compile + warm up
    t0 = time.perf_counter()
    with jax.profiler.trace(args.trace_dir):
        for _ in range(args.iters):
            out = call()
        jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / args.iters
    print(f"device {jax.devices()[0].device_kind}: {wall * 1e3:.3f} ms/call "
          f"under the tracer ({2 * n ** 3 / wall / 1e12:.2f} TFLOP/s)")

    path = sorted(glob.glob(os.path.join(args.trace_dir, "**",
                                         "*.xplane.pb"), recursive=True))[-1]
    rows = sorted(kernel_times(path).items(), key=lambda kv: -kv[1][0])
    per_phase = collections.defaultdict(float)
    print(f"trace: {path}")
    print(f"{'ms/call':>10} {'count':>6}  phase        line / kernel")
    for (line, name, phase), (ns, cnt) in rows[:args.top]:
        print(f"{ns / args.iters / 1e6:10.3f} {cnt:6d}  {phase:12s} "
              f"{line} / {name[:90]}")
    for (line, _, phase), (ns, _) in rows:
        per_phase[(line, phase)] += ns / args.iters / 1e6
    print("per line and phase (ms/call):")
    for (line, phase), ms in sorted(per_phase.items()):
        print(f"  {line:40s} {phase:12s} {ms:10.3f}")


if __name__ == "__main__":
    main()
