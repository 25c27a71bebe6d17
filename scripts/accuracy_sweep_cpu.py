"""Reference-scale accuracy sweeps on the CPU backend (native-f64 ground
truth). The slices and the CRT are exact integer work, so the accuracy
curves are the same on every backend.

Produced the committed results_committed/oz2_results_{d,f,md,mf}_accuracy_cpu_*
CSVs. Long-running (the dd oracle and the jnp path both grind at k=8192):
    python scripts/accuracy_sweep_cpu.py [d|f|md|mf|all]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROTOCOLS = {
    # dtype -> (phis, moduli_hi)  [reference: test_double.cu:19-23,
    # test_float.cu, test_mixed_double.cu, test_mixed_float.cu]
    "d": ((0.5, 2.0), 21),
    "f": ((0.0, 0.5, 1.0, 1.5), 20),
    "md": ((0.5, 2.0), 21),
    "mf": ((0.5, 2.0), 20),
}


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from gemmul8_tpu.bench.harness import accuracy_check

    for dtype, (phis, hi) in PROTOCOLS.items():
        if which not in (dtype, "all"):
            continue
        rows, path = accuracy_check(
            dtype=dtype, sizes=(1024, 2048, 4096, 8192), phis=phis,
            moduli=range(2, hi), fastmodes=(True, False), m=1024,
            outdir="results_committed")
        print(f"{dtype} sweep -> {path} ({len(rows)} rows)", flush=True)


if __name__ == "__main__":
    main()
