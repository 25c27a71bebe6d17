"""Single-call complex smoke test (reference one_accuracy_complex.cu:9,66-67:
Karatsuba strategy, accurate mode)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import gemmul8_tpu as g8
from gemmul8_tpu.bench.matrices import phi_matrix
from gemmul8_tpu.config import enable_compile_cache

NUM_MODULI = 15
N = 512

if __name__ == "__main__":
    enable_compile_cache()
    a = (phi_matrix(N, N, 0.5, 1) + 1j * phi_matrix(N, N, 0.5, 2)).astype(
        np.complex64)
    b = (phi_matrix(N, N, 0.5, 3) + 1j * phi_matrix(N, N, 0.5, 4)).astype(
        np.complex64)
    ref = a.astype(np.complex128) @ b.astype(np.complex128)
    c = np.asarray(g8.gemm(
        a, b, num_moduli=NUM_MODULI, fastmode=False,
        compute_type=g8.ComputeType.COMPLEX_KARATSUBA_MULT))
    err = np.abs(c.astype(np.complex128) - ref) / np.abs(ref)
    nerr = np.abs((a @ b).astype(np.complex128) - ref) / np.abs(ref)
    print(f"CGEMM        max relerr {nerr.max():.3e}  med {np.median(nerr):.3e}")
    print(f"OS2-kara-{NUM_MODULI}  max relerr {err.max():.3e}  med {np.median(err):.3e}")
