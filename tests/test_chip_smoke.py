"""chip_smoke.py's phases at tiny sizes on the CPU backend, its HLO
readers on recorded text, and its refusal to run without a GPU. The
full-size run belongs to the card (`python chip_smoke.py`)."""

import jax
import pytest

import chip_smoke as cs

REP = cs.Reporter("cpu test")


def test_main_refuses_a_backend_without_gpu(capsys):
    assert cs.main([]) == 1
    out, err = capsys.readouterr()
    assert '"ok"' not in out and "no GPU" in err


def test_check_raises_on_failure():
    cs.check(True, "fine")
    with pytest.raises(cs.SmokeFailure, match="broken"):
        cs.check(False, "broken")


@pytest.mark.parametrize("fastmode", [True, False])
def test_phase_dgemm(fastmode):
    hlo = cs.phase_dgemm(REP, 64, 0, fastmode, {}, with_native=fastmode)
    assert cs.slice_gemm_impl(hlo) == ["dot"]


def test_phase_sgemm():
    cs.phase_sgemm(REP, 64, 0)


def test_phase_complex():
    cs.phase_complex(REP, 32, 0)


def test_phase_schedules():
    cs.phase_schedules(REP, 32, 0, 64, 16, 32)


def test_phase_card_vs_cpu():
    cs.phase_card_vs_cpu(REP, 32, 0)


def test_phase_int8():
    cs.phase_int8(REP, 64, "%p = s8[2,8,8]{2,1,0} parameter(0)\n"
                  "%d = s32[2,8,8]{2,1,0} dot(%p, %p)\n")


def test_phase_sharded():
    cs.phase_sharded(REP, 32, 16, 0)


_HLO = {
    "cublas": ('  %custom-call.1 = (s32[14,64,64]{2,1,0}, s8[4194304]{0}) '
               'custom-call(%p, %q), custom_call_target="__cublas$gemm"',
               ["custom-call __cublas$gemm"]),
    "triton": ('  %f = s32[14,64,64]{2,1,0} fusion(%p, %q), kind=kCustom, '
               'backend_config={"fusion_backend_config":'
               '{"kind":"__triton_gemm"}}', ["fusion __triton_gemm"]),
    "dot": ("  ROOT %d = s32[14,64,64]{2,1,0} dot(%p, %q), "
            "lhs_batch_dims={0}", ["dot"]),
    "f32 only": ("  %d = f32[64,64]{1,0} dot(%x, %y)", []),
}


@pytest.mark.parametrize("case", sorted(_HLO))
def test_slice_gemm_impl_reads_hlo(case):
    text, want = _HLO[case]
    head = ("  %p = s8[14,64,64]{2,1,0} parameter(0)\n"
            "  %q = s8[14,64,64]{2,1,0} parameter(1)\n"
            "  %x = f32[64,64]{1,0} parameter(2)\n"
            "  %y = f32[64,64]{1,0} parameter(3)\n")
    assert cs.slice_gemm_impl(head + text) == want


def test_s8_relayouts_finds_int8_transposes():
    text = ("  %p = s8[14,64,64]{2,1,0} parameter(0)\n"
            "  %t = s8[14,64,64]{1,2,0} transpose(%p), dimensions={0,2,1}\n"
            "  %input_transpose_fusion = s8[14,64,64]{2,1,0} fusion(%p)\n"
            "  %u = u32[64,64]{0,1} transpose(%x)\n")
    assert cs.s8_relayouts(text) == [
        "t = s8[14,64,64]{1,2,0} transpose",
        "input_transpose_fusion = s8[14,64,64]{2,1,0} fusion"]


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_smoke_on_the_card(gpu, capsys):
    assert cs.main([]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"ok": true')
