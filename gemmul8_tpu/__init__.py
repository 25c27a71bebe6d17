"""gemmul8_tpu — high-precision GEMM emulation (Ozaki Scheme II) in JAX.

A from-scratch JAX/XLA framework with the capabilities of
ptrkgtsch/mixed-GEMMul8: FP64 / FP32 / mixed / complex GEMM emulated as
`num_moduli` exact int8 residue matmuls, recombined by CRT.
"""

from . import tables
from .api import gemm, gemm_batched, gemm_timed, workspace_bytes
from .types import C64Bits, ComputeType, F64Bits, bits_to_f64, f64_to_bits

__version__ = "0.1.0"

__all__ = [
    "gemm", "gemm_batched", "gemm_timed", "workspace_bytes", "tables",
    "ComputeType", "F64Bits", "C64Bits", "f64_to_bits", "bits_to_f64",
]
