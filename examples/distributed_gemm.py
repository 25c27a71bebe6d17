"""Mesh-sharded emulated DGEMM across all visible devices.

The reference is single-GPU (SURVEY.md §2.5); this is the scaling path:
2D mesh, per-shard encode + int8 matmuls, one exact integer psum_scatter
in residue space, CRT reconstruction on the owning shard. Runs on the
cards of one machine or, for a demo, on a virtual CPU mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python examples/distributed_gemm.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from gemmul8_tpu.config import enable_compile_cache
from gemmul8_tpu.parallel import distributed as dist
from gemmul8_tpu.types import bits_to_f64, f64_to_bits

if __name__ == "__main__":
    enable_compile_cache()
    mesh = dist.make_mesh()
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    print(f"devices: {len(jax.devices())}, mesh {nx}x{ny}")
    m, k, n = 64 * nx, 256 * ny, 64 * ny
    rng = np.random.default_rng(0)
    a = (rng.random((m, k)) - 0.5) * np.exp(rng.standard_normal((m, k)) * 0.5)
    b = (rng.random((k, n)) - 0.5) * np.exp(rng.standard_normal((k, n)) * 0.5)
    out = dist.gemm_sharded(f64_to_bits(a), f64_to_bits(b), mesh,
                            num_moduli=14)
    got = bits_to_f64(out, to_numpy=True)
    rel = np.abs(got - a @ b) / np.maximum(np.abs(a @ b), 1e-300)
    print(f"sharded emulated DGEMM ({m}x{k}x{n}): max relerr {rel.max():.2e}")
