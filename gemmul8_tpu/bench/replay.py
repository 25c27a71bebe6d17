"""Matrix-case save/replay — capability parity with ozIMMU's vendored
matfile tooling (/root/reference/ozIMMU_EF/test/matfile/*, used by
main_test.cu's matfile-driven replay): persist a GEMM case to disk,
reload it, and re-run any emulation config against it, so a failing
input found in production can be replayed under the test harness.
"""

from __future__ import annotations

import numpy as np


def save_case(path: str, a: np.ndarray, b: np.ndarray, **meta) -> None:
    """Persist operands (+ arbitrary scalar metadata) as one .npz."""
    np.savez_compressed(path, a=a, b=b,
                        **{f"meta_{k}": np.asarray(v) for k, v in
                           meta.items()})


def load_case(path: str):
    """-> (a, b, meta dict)."""
    z = np.load(path, allow_pickle=False)
    meta = {k[5:]: z[k][()] for k in z.files if k.startswith("meta_")}
    return z["a"], z["b"], meta


def replay(path: str, num_moduli: int = 14, fastmode: bool = True,
           **gemm_kwargs):
    """Re-run the emulator on a saved case; returns (C, max_relerr,
    med_relerr) against the dd oracle."""
    from .. import gemm
    from ..types import as_numpy
    from .native import dd_gemm, relerr_vs_dd

    a, b, _ = load_case(path)
    # as_numpy: without x64 an f64 result is an F64Bits pair — np.asarray
    # would stack the raw bit words instead of reassembling the doubles
    c = as_numpy(gemm(a, b, num_moduli=num_moduli, fastmode=fastmode,
                      **gemm_kwargs))
    hi, lo = dd_gemm(np.asarray(a, np.float64), np.asarray(b, np.float64))
    mx, med = relerr_vs_dd(c.astype(np.float64), hi, lo)
    return c, mx, med
