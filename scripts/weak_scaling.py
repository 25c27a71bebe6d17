"""Weak-scaling harness for the mesh-sharded emulated GEMM.

SURVEY.md §7 step 6 / BASELINE.json north star: measure emulated-DGEMM
TFLOP/s per card at 1 card and N cards with the problem scaled
proportionally to the device count (m and n grow with the mesh; global k
fixed below the 2^17 exactness bound).

On several processes: set GEMMUL8_COORD/NPROC/PROC_ID and run this same
script in every process — it calls multihost.initialize_from_env() first.
One process drives all the cards of one machine. For a functional demo it
also runs on the virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/weak_scaling.py --base 512 --moduli 14

VIRTUAL-MESH CAVEAT (measured, r5): on this single-core host NO virtual
timing metric measures scaling. Aggregate-vs-1dev (the r4 CSV) exceeded
1.0 from problem-size amortization — an artifact, not scaling; the
honest same-work sharded/unsharded ratio reported now is DOMINATED by
N-threads-on-1-core oversubscription + rendezvous stalls (7-30% at
8-16 devices) and is a crude LOWER bound on collective efficiency, not
an estimate of it. The virtual run's real value is functional: the full
collective schedule executes and the results are exact. Per-card
efficiency numbers require real cards.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

def measure(mesh, base: int, num_moduli: int, iters: int, repeats: int = 5):
    """One mesh point: `repeats` independent trials of an `iters`-chained
    measurement; reports the MEDIAN time plus min/max spread (single-trial
    numbers on a time-shared virtual mesh carried >10% noise — the r4
    weak-scaling CSV's 112% 2-device entry was exactly that artifact)."""
    import jax

    from gemmul8_tpu.parallel import distributed as dist
    from gemmul8_tpu.types import f64_to_bits

    nx, ny = mesh.shape["x"], mesh.shape["y"]
    ndev = nx * ny
    # weak scaling: per-device tile fixed at base x base; k fixed globally
    m, n = base * nx, base * ny
    k = min(base * 8, 1 << 17)
    rng = np.random.default_rng(0)
    a = (rng.random((m, k)) - .5) * np.exp(rng.standard_normal((m, k)) * .5)
    b = (rng.random((k, n)) - .5) * np.exp(rng.standard_normal((k, n)) * .5)
    A, B = f64_to_bits(a), f64_to_bits(b)

    def trial_median(fn):
        jax.block_until_ready(fn())   # compile + warm
        trials = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            jax.block_until_ready(out)
            trials.append((time.perf_counter() - t0) / iters)
        return float(np.median(trials)), trials

    dt, trials = trial_median(
        lambda: dist.gemm_sharded(A, B, mesh, num_moduli=num_moduli))
    tflops = 2 * m * n * k / dt / 1e12
    row = dict(devices=ndev, mesh=f"{nx}x{ny}", m=m, n=n, k=k,
               seconds=dt, seconds_min=float(np.min(trials)),
               seconds_max=float(np.max(trials)), trials=repeats,
               tflops=tflops, tflops_per_chip=tflops / ndev)
    if jax.default_backend() == "cpu":
        # virtual mesh: the honest overhead measure is the SAME global
        # problem run UNSHARDED on one device — sharded/unsharded
        # throughput isolates what the collectives cost on identical
        # work (aggregate-vs-1dev conflates problem-size amortization:
        # the r4 CSV's >1.0 entries were exactly that artifact)
        from gemmul8_tpu.api import _jit_core

        fn1 = _jit_core(num_moduli, True, "f64")
        dt1, _ = trial_median(lambda: fn1(A, B))
        row["seconds_unsharded_1dev"] = dt1
        row["efficiency_vs_unsharded"] = dt1 / dt
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", type=int, default=512,
                    help="per-device tile edge")
    ap.add_argument("--moduli", type=int, default=14)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5,
                    help="independent trials per mesh point (median kept)")
    ap.add_argument("--csv", type=str, default=None,
                    help="write rows to this CSV path")
    args = ap.parse_args()

    from gemmul8_tpu.parallel import multihost

    # multi-process entry: each process runs this same script with
    # GEMMUL8_COORD/NPROC/PROC_ID set; devices below then span every
    # process.
    multihost.initialize_from_env()

    import jax

    from gemmul8_tpu.parallel import distributed as dist

    ndev_total = len(jax.devices())
    virtual = jax.default_backend() == "cpu" and ndev_total > 1
    rows = []
    sizes = []
    # multi-process: every mesh must give each process >= 1 device — a
    # mesh excluding a process stalls its collective rendezvous (each
    # process joins every barrier). Start the ladder at process_count
    # and keep multiples of it; single-process keeps the full 1..N ladder.
    pc = jax.process_count()
    d = pc
    while d <= ndev_total:
        sizes.append(d)
        d *= 2
    if sizes and sizes[-1] != ndev_total and ndev_total % pc == 0:
        sizes.append(ndev_total)
    for nd in sizes:
        mesh = dist.make_mesh(nd)
        rows.append(measure(mesh, args.base, args.moduli, args.iters,
                            args.repeats))
        r = rows[-1]
        spread = (r["seconds_max"] - r["seconds_min"]) / r["seconds"] * 100
        extra = ""
        if "efficiency_vs_unsharded" in r:
            extra = (f"  sharded/unsharded eff "
                     f"{r['efficiency_vs_unsharded']*100:.1f}%")
        print(f"{r['devices']:3d} dev ({r['mesh']}): "
              f"{r['tflops']:.3f} TFLOP/s total, "
              f"{r['tflops_per_chip']:.3f}/chip "
              f"(median of {r['trials']}, spread {spread:.0f}%){extra}",
              flush=True)
    if len(rows) > 1:
        if virtual:
            # N virtual devices time-share the host CPU, so neither
            # per-chip nor aggregate-vs-1dev throughput measures scaling
            # (the latter conflates problem-size amortization — the r4
            # CSV read 112% at 2 devices that way). The honest virtual
            # metric is per-point sharded/unsharded on IDENTICAL work
            # (printed above; collective overhead only). Real per-card
            # efficiency needs real cards.
            effs = [r["efficiency_vs_unsharded"] for r in rows[1:]]
            print("virtual-mesh collective-overhead efficiency "
                  f"(sharded/unsharded, median-of-{args.repeats}): "
                  f"min {min(effs)*100:.1f}% over {len(effs)} mesh points")
        else:
            eff = rows[-1]["tflops_per_chip"] / rows[0]["tflops_per_chip"]
            print(f"weak-scaling per-chip efficiency {rows[0]['devices']}->"
                  f"{rows[-1]['devices']} devices: {eff*100:.1f}%")
        for r in rows:
            r["metric"] = ("sharded_vs_unsharded" if virtual
                           else "per_chip")
    if args.csv:
        import csv as _csv

        with open(args.csv, "w", newline="") as f:
            w = _csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
