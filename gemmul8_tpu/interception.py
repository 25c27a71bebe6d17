"""Matmul interception: route jnp matmuls through the emulator.

The JAX analog of the reference hijack libraries' LD_PRELOAD shims
(ozIMMU_EF/src/cublas.cu:283-300 re-exporting cublasDgemm_v2/Zgemm_v2;
cuMpSGEMM's rule-callback dispatch, src/default_cumpsgemm_rule.cu:6-50):
inside `override_matmuls()` every eligible `jnp.matmul` / `jnp.dot` /
`A @ B` on f64/f32/complex 2D operands is transparently computed by the
Ozaki-II engine. A user-supplied `rule` callback plays the role of
cuMpSGEMM's libcumpsgemm_rule.so: it sees (m, n, k, dtype) and picks the
mode per call. Calls below the intercept thresholds (env
GEMMUL8_INTERCEPT_THRESHOLD_*) pass through to native XLA, like the
reference's size-gated passthrough (ozIMMU gemm.cu:241-264).

Per-call profiling (CULiP analog, ozIMMU_EF/src/culip.cu): with
GEMMUL8_PROFILE=1 or profile=True, every intercepted call is recorded
(shape, dtype, mode, wall time) — read with get_profile_log().
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from . import config as cfg
from . import tables
from .api import gemm

_PROFILE_LOG: list = []


@dataclass
class CallRecord:
    m: int
    n: int
    k: int
    dtype: str
    mode: str
    seconds: float


def get_profile_log():
    return list(_PROFILE_LOG)


def clear_profile_log():
    _PROFILE_LOG.clear()


def default_rule(m: int, n: int, k: int, dtype) -> str:
    """Default dispatch rule (cf. cuMpSGEMM default rule: small sizes ->
    native, default_cumpsgemm_rule.cu:13-15): 'emulate' above the
    thresholds, 'native' below."""
    c = cfg.get_config()
    if c.compute_mode == "off":
        return "native"
    if (m < c.intercept_threshold_m or n < c.intercept_threshold_n
            or k < c.intercept_threshold_k):
        return "native"
    return c.compute_mode


_ELIGIBLE = (jnp.float32, jnp.float64, jnp.complex64, jnp.complex128)

# ---------------------------------------------------------------------------
# Imperative hijack control (cuMpSGEMM hijack_control analog,
# include/cumpsgemm/hijack_control.hpp:10-33): set/unset a forced mode
# without entering a context manager, and query the last intercepted call.
# ---------------------------------------------------------------------------

_FORCED_MODE: Optional[str] = None
_LAST_FUNC: str = ""
_DEPTH: int = 0  # override_matmuls nesting depth (is_library_loaded)


def set_compute_mode(mode: str) -> None:
    """Force every subsequent intercepted call to `mode` ('emulate' /
    'native'), overriding the rule callback."""
    global _FORCED_MODE
    if mode not in ("emulate", "native"):
        raise ValueError(mode)
    _FORCED_MODE = mode


def unset_compute_mode() -> None:
    global _FORCED_MODE
    _FORCED_MODE = None


def get_last_func_name() -> str:
    """Name+shape of the last intercepted matmul (hijack_control's
    last-called-function string)."""
    return _LAST_FUNC


def is_library_loaded() -> bool:
    """True while override_matmuls is active — the analog of the python
    binding's is-the-hijack-in-place check (cuMpSGEMM LD_PRELOAD probe,
    python/src/main.cpp:34-39): here the 'library' is the patched
    jnp/lax bindings, so active patching == loaded."""
    return _DEPTH > 0


def enable_restoring_AB_after_scaling() -> None:
    """cuMpSGEMM API-parity no-ops (python/src/main.cpp:72-79): its
    SCALING mode rescales A/B in place on the GPU and optionally restores
    them afterwards. JAX arrays are immutable — scaling never mutates the
    caller's operands (ops/mpgemm.py returns scaled copies) — so there is
    nothing to restore and both toggles are accepted for compatibility."""


def disable_restoring_AB_after_scaling() -> None:
    """See enable_restoring_AB_after_scaling."""


@contextlib.contextmanager
def override_matmuls(num_moduli: Optional[int] = None,
                     fastmode: Optional[bool] = None,
                     rule: Optional[Callable] = None,
                     profile: Optional[bool] = None):
    """Context that reroutes jnp.matmul / jnp.dot / jnp.einsum (2D matmul
    contractions) / the @ operator on eligible 2D f32/f64/complex operands
    through the emulator.

    Scope: the patches are PROCESS-GLOBAL, not thread- or call-scoped —
    any other thread or library code executing an eligible matmul while
    the context is active is rerouted too (exactly like the reference's
    LD_PRELOAD hijack, which intercepts every cuBLAS call in the process,
    ozIMMU_EF/src/cublas.cu:283-300). Nesting and restore are handled;
    concurrent entry from multiple threads is not supported."""
    c = cfg.get_config()
    nm = num_moduli if num_moduli is not None else c.num_moduli
    fm = fastmode if fastmode is not None else c.fastmode
    prof = profile if profile is not None else c.profile
    rule = rule or default_rule

    orig_matmul = jnp.matmul
    orig_dot = jnp.dot
    orig_einsum = jnp.einsum
    orig_dot_general = jax.lax.dot_general
    # reentrancy guard: the emulator itself issues dot_generals (encode
    # magnitude GEMM, slice products) — those must NOT be re-intercepted
    in_route = [False]

    def _eligible(a, b):
        if not (hasattr(a, "dtype") and hasattr(b, "dtype")):
            return False
        if not (getattr(a, "ndim", 0) == 2 and getattr(b, "ndim", 0) == 2):
            return False
        # BOTH operands must be emulatable: an `or` would intercept e.g.
        # f32 @ int32 and crash in canonicalization instead of passing
        # the call through to native XLA
        return (a.dtype in _ELIGIBLE and b.dtype in _ELIGIBLE)

    def _route(a, b, orig, op_a="N", op_b="N", **kwargs):
        global _LAST_FUNC
        if in_route[0] or kwargs or not _eligible(a, b):
            return orig(a, b, **kwargs)
        m, k = a.shape if op_a == "N" else a.shape[::-1]
        kb, n = b.shape if op_b == "N" else b.shape[::-1]
        if k > tables.MAX_K or k != kb:
            return orig(a, b)
        in_route[0] = True
        try:
            mode = _FORCED_MODE or rule(m, n, k, a.dtype)
            _LAST_FUNC = f"matmul[{m}x{k}x{n},{a.dtype}]->{mode}"
            traced = isinstance(a, jax.core.Tracer) or isinstance(
                b, jax.core.Tracer)
            t0 = time.perf_counter()
            if mode == "native":
                out = orig(a, b)
                label = "native"
            else:
                out = gemm(a, b, num_moduli=nm, fastmode=fm,
                           op_a=op_a, op_b=op_b)
                label = f"emulate-{nm}"
            if prof:
                if not traced:
                    jax.block_until_ready(out)  # wall time, not dispatch
                _PROFILE_LOG.append(CallRecord(
                    m, n, k, str(a.dtype),
                    label + (":traced" if traced else ""),
                    time.perf_counter() - t0))
            cfg.log_info(
                f"intercepted matmul {m}x{k}x{n} {a.dtype} -> {mode}")
            return out
        finally:
            in_route[0] = False

    def patched_matmul(a, b, **kw):
        return _route(a, b, orig_matmul, **kw)

    def patched_dot(a, b, **kw):
        return _route(a, b, orig_dot, **kw)

    def patched_einsum(*args, **kw):
        # 2-operand einsum spellings of a plain matmul ('ij,jk->ik' and
        # its transposed variants) are common call forms the reference's
        # LD_PRELOAD hijack would catch as cublasGemmEx — route them;
        # anything else passes through untouched.
        if (in_route[0] or kw or len(args) != 3
                or not isinstance(args[0], str)):
            return orig_einsum(*args, **kw)
        sub = args[0].replace(" ", "")
        a, b = args[1], args[2]
        lhs, arrow, out_sub = sub.partition("->")
        if arrow and not out_sub:
            # explicit scalar output ('ij,jk->'): a full contraction,
            # not a matmul — indistinguishable from the implicit form
            # once partitioned, so check the separator itself
            return orig_einsum(*args, **kw)
        parts = lhs.split(",")
        if len(parts) != 2:
            return orig_einsum(*args, **kw)
        s1, s2 = parts
        if (len(s1) != 2 or len(s2) != 2 or len(set(s1)) != 2
                or len(set(s2)) != 2):
            return orig_einsum(*args, **kw)
        shared = set(s1) & set(s2)
        if len(shared) != 1:
            return orig_einsum(*args, **kw)
        c = shared.pop()
        expected = (s1.replace(c, "") + s2.replace(c, ""))
        if out_sub and out_sub != expected:
            return orig_einsum(*args, **kw)
        if not out_sub and expected != "".join(sorted(expected)):
            # implicit output is alphabetical; a reversed result is a
            # transposed matmul — leave it to einsum
            return orig_einsum(*args, **kw)
        op_a = "N" if s1[1] == c else "T"
        op_b = "N" if s2[0] == c else "T"
        return _route(a, b, lambda x, y, **k2: orig_einsum(*args),
                      op_a=op_a, op_b=op_b)

    def patched_dot_general(lhs, rhs, dimension_numbers, precision=None,
                            preferred_element_type=None, **kw):
        def native(x, y, **k2):
            return orig_dot_general(
                lhs, rhs, dimension_numbers, precision=precision,
                preferred_element_type=preferred_element_type, **kw)

        if (in_route[0] or kw or precision is not None
                or preferred_element_type is not None):
            return native(lhs, rhs)
        try:
            ((lc, rc), (lb, rb)) = dimension_numbers
        except (TypeError, ValueError):
            return native(lhs, rhs)
        if (tuple(lb) != () or tuple(rb) != () or len(tuple(lc)) != 1
                or len(tuple(rc)) != 1):
            return native(lhs, rhs)
        op_a = "N" if tuple(lc) == (1,) else "T"
        op_b = "N" if tuple(rc) == (0,) else "T"
        return _route(lhs, rhs, native, op_a=op_a, op_b=op_b)

    # the @ operator does NOT dispatch through jnp.matmul — jax.Array and
    # Tracer hold their own __matmul__ references (captured at import), so
    # patch the classes too (jax itself installs these with setattr,
    # jax._src.numpy.array_methods)
    op_patches = []
    for cls_ in {type(jnp.zeros(0)), jax.core.Tracer}:
        f = getattr(cls_, "__matmul__", None)
        if f is None:
            continue
        in_dict = "__matmul__" in cls_.__dict__

        def _mm(self, other, _f=f):
            return _route(self, other, lambda x, y, **kw: _f(x, y))

        try:
            cls_.__matmul__ = _mm
        except (AttributeError, TypeError):
            continue  # immutable class on this jax version: skip
        op_patches.append((cls_, f, in_dict))

    jnp.matmul = patched_matmul
    jnp.dot = patched_dot
    jnp.einsum = patched_einsum
    jax.lax.dot_general = patched_dot_general
    global _DEPTH
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1
        jnp.matmul = orig_matmul
        jnp.dot = orig_dot
        jnp.einsum = orig_einsum
        jax.lax.dot_general = orig_dot_general
        for cls_, f, in_dict in op_patches:
            if in_dict:
                cls_.__matmul__ = f
            else:
                del cls_.__matmul__
