"""Low-memory moduli-chunked schedule + matmul interception."""

import numpy as np
import pytest

import jax.numpy as jnp

import gemmul8_tpu as g8
from gemmul8_tpu import interception as icept
from gemmul8_tpu.bench.matrices import phi_matrix
from gemmul8_tpu.planner import ModuliSchedule, plan_schedule, workspace_bytes


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_moduli_chunked_matches_full(fastmode, chunk):
    """Chunked execution must give bit-identical results to the one-shot
    path (same shifts, same exact integer arithmetic)."""
    a = phi_matrix(16, 128, 0.5, seed=300)
    b = phi_matrix(128, 16, 0.5, seed=301)
    full = np.asarray(g8.gemm(a, b, num_moduli=10, fastmode=fastmode))
    chunked = np.asarray(g8.gemm(a, b, num_moduli=10, fastmode=fastmode,
                                 moduli_chunk=chunk))
    np.testing.assert_array_equal(full, chunked)


def test_budget_driven_schedule():
    sched = plan_schedule(4096, 4096, 4096, 14,
                          budget_bytes=workspace_bytes(4096, 4096, 4096, 14) // 3)
    assert 1 <= sched.chunk < 14
    assert sum(w for _, w in sched.chunks()) == 14
    full = ModuliSchedule(14, 14)
    assert full.num_chunks == 1


def test_budget_param_through_api():
    a = phi_matrix(8, 64, 0.5, seed=310).astype(np.float32)
    b = phi_matrix(64, 8, 0.5, seed=311).astype(np.float32)
    out = np.asarray(g8.gemm(a, b, num_moduli=8,
                             max_workspace_bytes=200_000))
    ref = np.asarray(g8.gemm(a, b, num_moduli=8))
    np.testing.assert_array_equal(out, ref)


def test_interception_routes_and_profiles():
    a = jnp.asarray(phi_matrix(128, 128, 0.5, seed=320))
    b = jnp.asarray(phi_matrix(128, 128, 0.5, seed=321))
    native = np.asarray(a @ b)
    icept.clear_profile_log()
    with icept.override_matmuls(num_moduli=16, profile=True):
        out = np.asarray(jnp.matmul(a, b))
        small = np.asarray(jnp.matmul(a[:2, :2], b[:2, :2]))  # below threshold
    log = icept.get_profile_log()
    # native-routed calls are recorded too (CULiP logs every call)
    assert [r.mode for r in log] == ["emulate-16", "native"]
    assert np.abs((out - native) / native).max() < 1e-9
    # after exit, jnp.matmul restored
    assert np.array_equal(np.asarray(jnp.matmul(a, b)), native)


def test_interception_rule_callback():
    a = jnp.asarray(phi_matrix(128, 64, 0.5, seed=330))
    b = jnp.asarray(phi_matrix(64, 128, 0.5, seed=331))
    calls = []

    def rule(m, n, k, dtype):
        calls.append((m, n, k))
        return "native"

    with icept.override_matmuls(rule=rule):
        _ = jnp.matmul(a, b)
    assert calls == [(128, 128, 64)]


def test_hijack_control_forced_mode():
    from gemmul8_tpu import interception as itc

    a = np.random.default_rng(0).random((96, 96)).astype(np.float32)
    with itc.override_matmuls(num_moduli=8):
        itc.set_compute_mode("native")
        _ = jnp.matmul(jnp.asarray(a), jnp.asarray(a))
        assert itc.get_last_func_name().endswith("->native")
        itc.set_compute_mode("emulate")
        _ = jnp.matmul(jnp.asarray(a), jnp.asarray(a))
        assert itc.get_last_func_name().endswith("->emulate")
        itc.unset_compute_mode()


def test_plan_workspace_list():
    from gemmul8_tpu.planner import plan_workspace, workspace_bytes

    lst = [(256, 256, 256, 8), (1024, 1024, 1024, 14)]
    assert plan_workspace(lst) == workspace_bytes(1024, 1024, 1024, 14)


def test_ozimmu_auto_split():
    from gemmul8_tpu.baselines import ozimmu
    from gemmul8_tpu.types import f64_to_bits

    rng = np.random.default_rng(3)
    # narrow dynamic range -> small split count suffices at high threshold
    a = f64_to_bits(rng.random((64, 64)) + 0.5)
    s_easy = ozimmu.auto_num_split(a, a, threshold=20.0)
    # wide dynamic range -> needs more slices
    w = (rng.random((64, 64)) - 0.5) * np.exp(rng.standard_normal((64, 64)) * 8)
    b = f64_to_bits(w)
    s_hard = ozimmu.auto_num_split(b, b, threshold=1.0)
    assert s_easy <= s_hard
    assert 3 <= s_easy <= 16 and 3 <= s_hard <= 16


def test_n_panel_bitexact():
    """Column-panel schedule (for problems whose slices exceed device
    memory) is
    bit-identical to one-shot in fast mode."""
    from gemmul8_tpu.core import gemm as gg
    from gemmul8_tpu.types import f64_to_bits

    rng = np.random.default_rng(0)
    a = (rng.random((48, 200)) - .5) * np.exp(rng.standard_normal((48, 200)))
    b = (rng.random((200, 100)) - .5) * np.exp(rng.standard_normal((200, 100)))
    A, B = f64_to_bits(a), f64_to_bits(b)
    ref = gg.gemm_core(A, B, 14, True, "f64")
    got = gg.gemm_core_panels(A, B, 14, True, "f64", n_panel=32)
    assert np.array_equal(np.asarray(ref.hi), np.asarray(got.hi))
    assert np.array_equal(np.asarray(ref.lo), np.asarray(got.lo))
    out = np.asarray(g8.gemm(a, b, num_moduli=14, n_panel=32))
    assert np.abs((out - a @ b) / (a @ b)).max() < 1e-9
