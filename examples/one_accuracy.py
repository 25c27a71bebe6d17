"""Single-call smoke test: SGEMM emulation relative error printout.

Equivalent of the reference's one_accuracy.cu (testing/one_accuracy.cu:7-80):
one 1024^3 phi=0.5 call at 15 moduli, print max/median relerr vs native."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import gemmul8_tpu as g8
from gemmul8_tpu.bench.native import dd_gemm
from gemmul8_tpu.bench.matrices import phi_matrix, relerr_stats
from gemmul8_tpu.config import enable_compile_cache

NUM_MODULI = 15
PHI = 0.5
N = 1024

if __name__ == "__main__":
    enable_compile_cache()
    a = phi_matrix(N, N, PHI, seed=123456).astype(np.float32)
    b = phi_matrix(N, N, PHI, seed=123457).astype(np.float32)
    ref = dd_gemm(a.astype(np.float64), b.astype(np.float64))[0]
    c = np.asarray(g8.gemm(a, b, num_moduli=NUM_MODULI, fastmode=True))
    mx, med = relerr_stats(c.astype(np.float64), ref)
    nx, nmed = relerr_stats((a @ b).astype(np.float64), ref)
    print(f"SGEMM   max relerr {nx:.3e}  med {nmed:.3e}")
    print(f"OS2-{NUM_MODULI}  max relerr {mx:.3e}  med {med:.3e}")
