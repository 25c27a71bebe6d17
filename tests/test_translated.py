"""The device-facing branches: float64 and complex results come back as
device arrays wherever x64 gives float64 arrays, the compile-cache helper,
the device peak table, the GPU gate and the timing helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gemmul8_tpu as g8
from gemmul8_tpu import api, config, planner
from gemmul8_tpu.bench import timing
from gemmul8_tpu.bench.matrices import phi_matrix
from gemmul8_tpu.ops import mpgemm
from gemmul8_tpu.types import backend_has_f64

A = phi_matrix(12, 20, 0.5, seed=1)
B = phi_matrix(20, 8, 0.5, seed=2)


def test_backend_has_f64_on_cpu_with_x64():
    assert backend_has_f64()


@pytest.mark.parametrize("entry", ["numpy", "device", "batched", "timed",
                                   "epilogue"])
def test_float64_in_gives_float64_array_out(entry):
    if entry == "numpy":
        out = g8.gemm(A, B)
    elif entry == "device":
        out = g8.gemm(jnp.asarray(A), jnp.asarray(B))
    elif entry == "batched":
        out = g8.gemm_batched(np.stack([A, A]), np.stack([B, B]))[1]
    elif entry == "timed":
        out, _ = g8.gemm_timed(A, B)
    else:
        out = g8.gemm(A, B, alpha=-1.0, beta=1.0, c=np.ones((12, 8)))
    assert isinstance(out, jax.Array) and out.dtype == jnp.float64
    ref = A @ B if entry != "epilogue" else 1.0 - A @ B
    assert np.max(np.abs(np.asarray(out) - ref)) < 1e-12


def test_bits_in_gives_bits_out():
    out = g8.gemm(g8.f64_to_bits(A), g8.f64_to_bits(B))
    assert isinstance(out, g8.F64Bits)
    np.testing.assert_array_equal(np.asarray(g8.bits_to_f64(out)),
                                  np.asarray(g8.gemm(A, B)))


def test_f64_to_bits_splits_on_device():
    bits = g8.f64_to_bits(A)
    assert isinstance(bits.hi, jax.Array) and bits.hi.dtype == jnp.uint32
    u = A.view(np.uint32).reshape(A.shape + (2,))
    np.testing.assert_array_equal(np.asarray(bits.hi), u[..., 1])
    np.testing.assert_array_equal(np.asarray(bits.lo), u[..., 0])


@pytest.mark.parametrize("entry", ["gemm", "batched", "mp_cgemm",
                                   "complex128"])
def test_complex_results_are_device_arrays(entry):
    z1 = (A + 1j * A[::-1]).astype(np.complex64)
    z2 = (B + 1j * B[::-1]).astype(np.complex64)
    tol = 1e-6
    if entry == "gemm":
        out, dt = g8.gemm(z1, z2, num_moduli=8), jnp.complex64
    elif entry == "batched":
        out = g8.gemm_batched(z1[None], z2[None], num_moduli=8)[0]
        dt = jnp.complex64
    elif entry == "mp_cgemm":
        # BF16X3: three bf16 products, ~2^-18 relative
        out, dt, tol = mpgemm.mp_cgemm(z1, z2), jnp.complex64, 2e-5
    else:
        z1, z2 = z1.astype(np.complex128), z2.astype(np.complex128)
        out, dt = g8.gemm(z1, z2, num_moduli=14), jnp.complex128
    assert isinstance(out, jax.Array) and out.dtype == dt
    ref = z1.astype(np.complex128) @ z2.astype(np.complex128)
    assert np.median(np.abs(np.asarray(out) - ref) / np.abs(ref)) < tol


def test_complex64_beta_with_device_c():
    z1 = (A + 1j * A[::-1]).astype(np.complex64)
    z2 = (B + 1j * B[::-1]).astype(np.complex64)
    c = jnp.ones((12, 8), jnp.complex64) * (1 - 2j)
    out = g8.gemm(z1, z2, beta=0.5, c=c, num_moduli=10)
    ref = (z1.astype(np.complex128) @ z2.astype(np.complex128)
           + 0.5 * (1 - 2j))
    assert out.dtype == jnp.complex64
    assert np.max(np.abs(np.asarray(out) - ref) / np.abs(ref)) < 1e-5


def test_compile_cache_honours_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert config.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_compile_cache_default_is_repo_dir(monkeypatch):
    import os

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert config.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_peak_table_known_device():
    peaks = timing.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["int8_tops"] == 1979.0 and peaks["hbm_tb_per_s"] == 3.35


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_table_raises_on_unknown_device(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        timing.device_peaks(kind)


def test_require_gpu_exits_without_a_gpu():
    with pytest.raises(SystemExit) as e:
        timing.require_gpu()
    assert e.value.code == 1


def test_card_info_reads_first_card(monkeypatch):
    import subprocess

    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100, 700 W\n"

    seen = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: seen.append(cmd) or Done())
    assert timing.card_info() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen[0][0] == "nvidia-smi"


def test_chained_time_runs_each_step_once_per_iteration():
    steps = []

    def step(state):
        steps.append(state)
        return state + 1

    dt, state = timing.chained_time(step, jnp.int32(0), 4)
    assert int(state) == 5 and len(steps) == 5   # one warm-up + 4 timed
    assert dt >= 0.0


def test_int8_probe_rate_is_positive():
    from gemmul8_tpu.core import slicegemm as sg

    tops = sg.int8_peak_probe(64, iters=2)
    assert np.isfinite(tops) and tops > 0


def test_timed_core_phases_and_result():
    out, times = g8.gemm_timed(A, B, iters=2)
    assert len(times) == 4 and all(t >= 0.0 for t in times)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(g8.gemm(A, B)))


@pytest.mark.parametrize("m,k,n", [(16, 8, 32), (16, 40, 8)])
def test_epilogue_timing_row_takes_c_of_its_own(m, k, n):
    """The axpby timing row's C is (m, n) whatever k is (C was once
    sliced out of A's bits, which broke for k < n)."""
    from gemmul8_tpu.bench.harness import _fused_gemm_seconds

    a = phi_matrix(m, k, 0.5, seed=3)
    b = phi_matrix(k, n, 0.5, seed=4)
    dt = _fused_gemm_seconds(a, b, 10, True, 1, axpby=(1.7, -0.3))
    assert dt > 0.0


def test_workspace_counts_unpadded_operands():
    m, n, k, L = 9, 13, 70, 14
    from gemmul8_tpu import tables

    want = (L * (m * k + k * n) + 2 * L * m * n * 4
            + tables.num_limbs(L) * m * n * 4 + (m + n) * 4)
    assert planner.workspace_bytes(m, n, k, L) == want
    assert api.workspace_bytes(m, n, k, L) == want
