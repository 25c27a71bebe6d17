"""Workspace / memory planner.

Parity with gemmul8::workSize (GEMMul8 src/gemmul8.cu:27-147)
— the reference carves A8i | B8i | C8u | C32i | sftA | sftB out of one user
buffer; under JAX/XLA the allocator owns memory, so this planner (a) reports
the expected peak auxiliary footprint for capacity planning, and (b) decides
the moduli-chunked low-memory schedule (the reference's `memory-lt` branch
capability): when the slice buffers exceed a budget, the moduli loop is
split into chunks whose slices are encoded, multiplied, reduced and
CRT-accumulated before the next chunk is materialized.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import tables
from .types import ComputeType


def workspace_bytes(m: int, n: int, k: int, num_moduli: int,
                    compute_type: ComputeType = ComputeType.REAL_DEFAULT) -> int:
    """Expected peak auxiliary bytes for one emulated GEMM call.

    Models the one-shot schedule, which materializes the full (L, m, n)
    int32 slice-product batch and int32 residues. Operands are held at
    their own shapes (the plain path pads nothing; any padding the int8
    GEMM library does internally is its own workspace). Per strategy it
    counts every simultaneously-live tensor batch:
    REAL 1 slice set/side, 1 product batch; CLASSIC 2 slice sets/side
    (re, im), 4 product batches (rr, ii, ri, ir); KARATSUBA 3 slice
    sets/side (re, im, re+im), 3 product batches; BIG_MATRIX doubled
    dims, 1 of each, plus the pre-concat re/im slices of A that co-live
    with the assembled block operand."""
    mm, kk, nn = m, k, n   # complex big-matrix doubles mm and kk below
    L = num_moduli
    extra_slices = 0
    if compute_type == ComputeType.COMPLEX_BIG_MATRIX_ENCODE:
        # a8r/a8i/-a8i co-live with the assembled (L, 2m, 2k) block
        extra_slices = 3 * L * mm * kk
        mm, kk = 2 * mm, 2 * kk
        slice_sets, prod_batches, resid_batches = 1, 1, 1
    elif compute_type == ComputeType.COMPLEX_CLASSIC_MULT:
        slice_sets, prod_batches, resid_batches = 2, 4, 2
    elif compute_type == ComputeType.COMPLEX_KARATSUBA_MULT:
        slice_sets, prod_batches, resid_batches = 3, 3, 2
    else:
        slice_sets, prod_batches, resid_batches = 1, 1, 1
    slices = (L * (mm * kk + kk * nn) * slice_sets
              + extra_slices)                                          # int8
    products = prod_batches * L * mm * nn * 4                    # int32
    residues = resid_batches * L * mm * nn * 4                   # int32
    limbs = tables.num_limbs(num_moduli) * mm * nn * 4           # int32
    sft = (mm + nn) * 4
    return slices + products + residues + limbs + sft


@dataclass(frozen=True)
class ModuliSchedule:
    """How the moduli loop is chunked for the low-memory mode."""

    num_moduli: int
    chunk: int  # moduli per materialized chunk

    @property
    def num_chunks(self) -> int:
        return math.ceil(self.num_moduli / self.chunk)

    def chunks(self):
        out = []
        j = 0
        while j < self.num_moduli:
            out.append((j, min(self.chunk, self.num_moduli - j)))
            j += self.chunk
        return out


def plan_schedule(m: int, n: int, k: int, num_moduli: int,
                  budget_bytes: int | None = None) -> ModuliSchedule:
    """Pick the moduli chunking. None budget -> all moduli at once."""
    if budget_bytes is None:
        return ModuliSchedule(num_moduli, num_moduli)
    # per materialized modulus: int8 A and B slices, plus the int32
    # slice-product AND the int32 residue tensor, which co-live on the
    # chunked jnp path (core/gemm.py) — 8 bytes per output element
    per_modulus = m * k + k * n + m * n * 8
    fixed = tables.num_limbs(num_moduli) * m * n * 4
    chunk = max(1, (budget_bytes - fixed) // max(per_modulus, 1))
    return ModuliSchedule(num_moduli, min(int(chunk), num_moduli))


def plan_workspace(gemm_list) -> int:
    """Peak auxiliary bytes over a list of upcoming GEMMs — the analog of
    ozIMMU's `reallocate_working_memory(gemm_list)` (ozIMMU_EF/include/
    ozimmu/ozimmu.hpp:14-100), which sizes one shared buffer for a whole
    sequence of calls. Entries: (m, n, k, num_moduli) or
    (m, n, k, num_moduli, compute_type)."""
    peak = 0
    for entry in gemm_list:
        m, n, k, num_moduli = entry[:4]
        ct = entry[4] if len(entry) > 4 else ComputeType.REAL_DEFAULT
        peak = max(peak, workspace_bytes(m, n, k, num_moduli, ct))
    return peak
