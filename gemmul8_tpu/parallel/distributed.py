"""Mesh-sharded emulated GEMM.

The reference is strictly single-GPU (SURVEY.md §2.5 — no NCCL/MPI anywhere);
this module is the scaling design it lacks: operands are 2D-sharded over a
Mesh('x','y'), each shard encodes its local residue slices (with shift
statistics psum/pmax'd over the k-sharded axis so every shard picks the
same globally-valid shift), int8 slice products run per shard, and the
k-partial int32 products are combined with a single exact integer
`psum_scatter` **in residue space** — communication stays integer-typed and
CRT reconstruction happens exactly once, on the shard that owns the output
tile. Cards joined all to all (NVLink) reach each other at one rate, so the
mesh shape follows the algorithm alone: m over x, k over y.

Sharding layout (forward step):
  A (m, k)  -> P('x', 'y')     row blocks x, k blocks y
  B (k, n)  -> P('y', 'x')     k blocks y, n blocks x (re-gathered over x
                               inside the step; the scatter re-shards n
                               over y)
  C (m, n)  -> P('x', 'y')

Exactness across shards: the int32 dot-product bound is on the *global* k
(k_total <= 2^17, include/gemmul8.hpp:20-equivalent), so summing int32
partials over shards cannot overflow; residues add homomorphically
(sum mod m == sum of partial residues mod m).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import tables
from ..core import encode as enc
from ..core import reconstruct as rec
from ..core import slicegemm as sg
from ..types import F64Bits


def make_mesh(n_devices: Optional[int] = None, shape=None,
              axis_names=("x", "y")) -> Mesh:
    """Build a 2D device mesh. With no shape, factor n_devices as close to
    square as possible (x*y = n).

    Multi-process: a sub-mesh must include devices from EVERY process —
    a process excluded from the mesh still joins every collective
    rendezvous and stalls it (measured: gloo DEADLINE_EXCEEDED). The
    global device list is process-major, so a naive prefix would take
    all of process 0's devices first; pick n/process_count from each
    process instead."""
    devs = jax.devices()
    if shape is not None:
        # explicit shape wins: size the device pick to it
        n_devices = shape[0] * shape[1]
    n = n_devices or len(devs)
    pc = jax.process_count()
    if pc > 1 and n < len(devs):
        per, rem = divmod(n, pc)
        if rem:
            raise ValueError(
                f"n_devices={n} must be a multiple of process_count={pc} "
                "(every process must own >= 1 mesh device)")
        picked = []
        for p in range(pc):
            local = [d for d in devs if d.process_index == p]
            picked += local[:per]
        devs = picked
    else:
        devs = list(devs[:n])
    if shape is None:
        x = int(np.floor(np.sqrt(n)))
        while n % x:
            x -= 1
        shape = (x, n // x)
    return jax.make_mesh(shape, axis_names, devices=devs)


def _encode_local(x, num_moduli, axis, axis_name):
    if isinstance(x, F64Bits):
        return enc.encode_fast_f64(x, num_moduli, axis, axis_name)
    return enc.encode_fast_f32(x, num_moduli, axis, axis_name)


def _gather_b(b):
    """Reassemble the full-n local B block from the P('y','x') 2D shards:
    an all_gather over x, transient (freed after encode). The
    PERSISTENT per-shard footprint is the true 2D shard — the L-times-
    amplified int8 slice tensors are bounded by the n_panel schedule, not
    by full n (VERDICT r1: replicated-B memory wall)."""
    if isinstance(b, F64Bits):
        return F64Bits(jax.lax.all_gather(b.hi, "x", axis=1, tiled=True),
                       jax.lax.all_gather(b.lo, "x", axis=1, tiled=True))
    return jax.lax.all_gather(b, "x", axis=1, tiled=True)


def _accurate_sfts_sharded(a, b, num_moduli: int):
    """Accurate-mode ('int8tc') shift selection with the contraction dim
    sharded over 'y': global emax via pmax, ONE extra int8 magnitude GEMM
    per shard with its k-partial psum'd over y (exact: mags <= 2^6, so
    k_total * 2^12 < 2^31), then row/col maxes (cols pmax'd over x)."""
    mag_a, emax_a = enc.mag7_sharded(a, axis=1, axis_name="y")
    mag_b, emax_b = enc.mag7_sharded(b, axis=0, axis_name="y")
    s = jax.lax.dot_general(mag_a, mag_b, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    s = jax.lax.psum(s, "y")
    smax_a = jnp.max(s, axis=1, keepdims=True)
    smax_b = jax.lax.pmax(jnp.max(s, axis=0, keepdims=True), "x")
    is64a = isinstance(a, F64Bits)
    is64b = isinstance(b, F64Bits)
    sft_a = enc.accurate_sft(smax_a, emax_a, num_moduli, 53 if is64a else 24)
    sft_b = enc.accurate_sft(smax_b, emax_b, num_moduli, 53 if is64b else 24)
    return sft_a, sft_b


def _strided_panel(x, s: int, w: int, ny: int):
    """Panel s of the n axis as the UNION of every y-shard's s-th output
    sub-block (global cols j*(n/ny) + [s*w, (s+1)*w) for each j): after
    psum_scatter over y, shard j receives exactly its own contiguous
    columns, so concatenating panels reproduces the one-shot P('x','y')
    layout bit-for-bit (a contiguous panel would scatter each panel's
    cols across shards and permute the global column order)."""
    def f(arr):
        kloc, n = arr.shape
        r = arr.reshape(kloc, ny, n // ny)[:, :, s * w:(s + 1) * w]
        return r.reshape(kloc, ny * w)
    if isinstance(x, F64Bits):
        return F64Bits(f(x.hi), f(x.lo))
    return f(x)


def _encode_with_sft_op(x, sft, num_moduli: int):
    if isinstance(x, F64Bits):
        return enc.encode_accurate_f64(x, sft, num_moduli)
    return enc.encode_accurate_f32(x, sft, num_moduli)


def _scatter_reconstruct(c32_partial, sft_a, sft_b, num_moduli, out_kind):
    """Exact integer reduce-scatter of the k-partials over 'y' (scattering
    the n axis) + per-shard reconstruct of the owned tile."""
    c32 = jax.lax.psum_scatter(c32_partial, "y", scatter_dimension=2,
                               tiled=True)
    n_local = c32.shape[2]
    j = jax.lax.axis_index("y").astype(jnp.int32)
    sft_b_tile = jax.lax.dynamic_slice(
        sft_b, (jnp.int32(0), j * jnp.int32(n_local)), (1, n_local))
    r = sg.mod_reduce(c32, num_moduli)
    return rec.reconstruct(r, sft_a, sft_b_tile, num_moduli, out_kind)


def _sharded_body(a, b, num_moduli: int, out_kind: str, ny: int,
                  fastmode: bool = True, n_panel: int | None = None):
    """Per-shard body (inside shard_map). a: local (m/x, k/y); b: local 2D
    shard (k/y, n/x). Returns local C tile (m/x, n/y).

    n_panel: encode/multiply/scatter B in n-panels so the L-amplified int8
    slice tensors never exceed (L, k/y, n_panel) — the low-memory schedule
    for n beyond device memory (fast mode only: column stats are panel-local there;
    accurate-mode row shifts need the full-n product max)."""
    b_full = _gather_b(b)
    if fastmode:
        a8, sft_a = _encode_local(a, num_moduli, axis=1, axis_name="y")
        if n_panel is None:
            b8, sft_b = _encode_local(b_full, num_moduli, axis=0,
                                      axis_name="y")
            return _scatter_reconstruct(sg.slice_products(a8, b8), sft_a,
                                        sft_b, num_moduli, out_kind)
        n = b_full.shape[1]
        if n_panel % ny or (n // ny) % (n_panel // ny):
            raise ValueError(
                f"n_panel={n_panel} must divide as n_panel/ny | n/ny")
        w = n_panel // ny
        outs = []
        for s in range(n // n_panel):
            bp = _strided_panel(b_full, s, w, ny)
            b8, sft_b = _encode_local(bp, num_moduli, axis=0, axis_name="y")
            outs.append(_scatter_reconstruct(
                sg.slice_products(a8, b8), sft_a, sft_b, num_moduli,
                out_kind))
        if out_kind == "f64":
            return F64Bits(jnp.concatenate([o.hi for o in outs], axis=1),
                           jnp.concatenate([o.lo for o in outs], axis=1))
        return jnp.concatenate(outs, axis=1)
    # accurate mode (int8tc): one-shot only
    if n_panel is not None:
        raise NotImplementedError("n_panel requires fastmode")
    sft_a, sft_b = _accurate_sfts_sharded(a, b_full, num_moduli)
    a8 = _encode_with_sft_op(a, sft_a, num_moduli)
    b8 = _encode_with_sft_op(b_full, sft_b, num_moduli)
    return _scatter_reconstruct(sg.slice_products(a8, b8), sft_a, sft_b,
                                num_moduli, out_kind)


def _sharded_body_complex(a_re, a_im, b_re, b_im, num_moduli: int,
                          out_kind: str, compute_type=None):
    """Complex strategies under the mesh, all three first-class (parity
    with gemmul8.cu:579-1052; VERDICT r4 item 5):

    - BIG_MATRIX_ENCODE: Re/Im of each row/col share one joint shift
      (stats psum/pmax'd over the k-sharded 'y'), the encoded slices are
      assembled into the [[Re, -Im], [Im, Re]] block form LOCALLY
      (shape-doubling commutes with k-sharding: the doubled contraction
      dim is just two stacked k-sharded halves), and ONE int8 GEMM of
      doubled size per modulus runs per shard.
    - CLASSIC_MULT: 4 local slice GEMMs; Re = RR-II, Im = RI+IR combined
      in int32 partial space BEFORE the scatter (int32-exact: the bound
      is on global k, enforced at entry).
    - KARATSUBA_MULT: the re-centered (Re+Im) slices are built PER SHARD
      (_recenter_add_int8 is elementwise over the local k-slab, so it
      commutes with k-sharding); 3 local GEMMs, E-F / G-E-F combined
      locally, one scatter.

    All paths end in the same exact integer psum_scatter over 'y' +
    per-shard reconstruct; operand widths may differ (per-operand encode
    dispatch, same as single-device)."""
    from ..core.complexgemm import _recenter_add_int8
    from ..types import ComputeType

    if compute_type is None:
        compute_type = ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    br_full = _gather_b(b_re)
    bi_full = _gather_b(b_im)
    a8r, a8i, sft_a = enc.encode_fast_complex(a_re, a_im, num_moduli,
                                              axis=1, axis_name="y")
    b8r, b8i, sft_b = enc.encode_fast_complex(br_full, bi_full, num_moduli,
                                              axis=0, axis_name="y")
    m_local = a_re.shape[0]

    def split(out):
        if out_kind == "f64":
            return (F64Bits(out.hi[:m_local], out.lo[:m_local]),
                    F64Bits(out.hi[m_local:], out.lo[m_local:]))
        return out[:m_local], out[m_local:]

    if compute_type == ComputeType.COMPLEX_BIG_MATRIX_ENCODE:
        neg_a8i = (-a8i.astype(jnp.int32)).astype(jnp.int8)
        top = jnp.concatenate([a8r, neg_a8i], axis=2)
        bot = jnp.concatenate([a8i, a8r], axis=2)
        a_blk = jnp.concatenate([top, bot], axis=1)    # (L, 2m/x, 2k/y)
        b_blk = jnp.concatenate([b8r, b8i], axis=1)    # (L, 2k/y, n)
        c32_partial = sg.slice_products(a_blk, b_blk)  # (L, 2m/x, n)
        sft_a2 = jnp.concatenate([sft_a, sft_a], axis=0)
        return split(_scatter_reconstruct(c32_partial, sft_a2, sft_b,
                                          num_moduli, out_kind))
    if compute_type == ComputeType.COMPLEX_CLASSIC_MULT:
        rr = sg.slice_products(a8r, b8r)
        ii = sg.slice_products(a8i, b8i)
        ri = sg.slice_products(a8r, b8i)
        ir = sg.slice_products(a8i, b8r)
        re_part, im_part = rr - ii, ri + ir
    elif compute_type == ComputeType.COMPLEX_KARATSUBA_MULT:
        s_a = _recenter_add_int8(a8r, a8i, num_moduli)
        s_b = _recenter_add_int8(b8r, b8i, num_moduli)
        e = sg.slice_products(a8r, b8r)
        f = sg.slice_products(a8i, b8i)
        g = sg.slice_products(s_a, s_b)
        re_part, im_part = e - f, g - e - f
    else:
        raise ValueError(compute_type)
    # one scatter over [Re; Im] stacked along rows (the pair analog of
    # the single-device _reconstruct_pair)
    c2 = jnp.concatenate([re_part, im_part], axis=1)
    sft_a2 = jnp.concatenate([sft_a, sft_a], axis=0)
    return split(_scatter_reconstruct(c2, sft_a2, sft_b, num_moduli,
                                      out_kind))


@lru_cache(maxsize=None)
def _build_sharded(mesh, num_moduli: int, out_kind: str, is_f64_a: bool,
                   is_f64_b: bool, fastmode: bool = True, n_panel=None):
    ny = mesh.shape["y"]
    a_spec = F64Bits(P("x", "y"), P("x", "y")) if is_f64_a else P("x", "y")
    b_spec = F64Bits(P("y", "x"), P("y", "x")) if is_f64_b else P("y", "x")
    if out_kind == "f64":
        out_spec = F64Bits(P("x", "y"), P("x", "y"))
    else:
        out_spec = P("x", "y")
    fn = jax.shard_map(
        partial(_sharded_body, num_moduli=num_moduli, out_kind=out_kind,
                ny=ny, fastmode=fastmode, n_panel=n_panel),
        mesh=mesh, in_specs=(a_spec, b_spec), out_specs=out_spec,
        check_vma=False)
    return jax.jit(fn)


def gemm_sharded(a, b, mesh: Mesh, num_moduli: int = 14,
                 out_dtype: Optional[str] = None,
                 fastmode: bool = True, n_panel: Optional[int] = None):
    """Emulated GEMM 2D-sharded over `mesh`.

    a: (m, k) F64Bits or f32 array; b: (k, n) same — both operands are
    2D-sharded (A P('x','y'), B P('y','x')); inside the step B's n axis
    is re-gathered over x transiently. m must divide by mesh.x, k by
    mesh.y, n by mesh.x and mesh.y. fastmode=False runs the accurate
    ('int8tc') shift selection with its magnitude GEMM psum'd over the
    k axis. n_panel bounds the per-shard slice-tensor footprint (fast
    mode). Returns C sharded P('x','y')."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a.shape} x {b.shape}")
    if k > tables.MAX_K:
        raise ValueError("global k exceeds 2^17 int32-exactness bound")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    if m % nx or k % ny or n % ny or n % nx:
        raise ValueError(f"shapes ({m},{k},{n}) must divide mesh {nx}x{ny}")
    is64a, is64b = isinstance(a, F64Bits), isinstance(b, F64Bits)
    out_kind = out_dtype or ("f64" if (is64a or is64b) else "f32")
    fn = _build_sharded(mesh, num_moduli, out_kind, is64a, is64b, fastmode,
                        n_panel)
    # place operands
    a_sh = jax.device_put(a, _sharding_for(mesh, P("x", "y"), is64a))
    b_sh = jax.device_put(b, _sharding_for(mesh, P("y", "x"), is64b))
    return fn(a_sh, b_sh)


@lru_cache(maxsize=None)
def _build_sharded_complex(mesh, num_moduli: int, out_kind: str,
                           is_f64_a: bool, is_f64_b: bool, compute_type=None):
    part_a = (lambda s: F64Bits(s, s)) if is_f64_a else (lambda s: s)
    part_b = (lambda s: F64Bits(s, s)) if is_f64_b else (lambda s: s)
    a_spec = part_a(P("x", "y"))
    b_spec = part_b(P("y", "x"))
    if out_kind == "f64":
        out_spec = F64Bits(P("x", "y"), P("x", "y"))
    else:
        out_spec = P("x", "y")
    fn = jax.shard_map(
        partial(_sharded_body_complex, num_moduli=num_moduli,
                out_kind=out_kind, compute_type=compute_type),
        mesh=mesh, in_specs=(a_spec, a_spec, b_spec, b_spec),
        out_specs=(out_spec, out_spec), check_vma=False)
    return jax.jit(fn)


def gemm_sharded_complex(a, b, mesh: Mesh, num_moduli: int = 14,
                         out_dtype: Optional[str] = None,
                         compute_type=None):
    """Complex emulated GEMM sharded over `mesh` (fast mode): operands are
    complex numpy arrays or canonical (re, im) tuples — widths may DIFFER
    between A and B (per-operand encode dispatch, like single-device);
    returns (re, im) sharded P('x','y') in the target real format.

    compute_type selects the strategy (default big-matrix); all three are
    shardable — k-sharding commutes with the big-matrix shape-doubling,
    with classic's 4-product combine, and with karatsuba's re-centered
    residue adds (SURVEY §7; reference gemmul8.cu:579-1052)."""
    from ..core.complexgemm import _KMAX, _canon_complex
    from ..types import ComputeType

    if compute_type in (None, ComputeType.REAL_DEFAULT):
        compute_type = ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    a_re, a_im, kind_a = _canon_complex(a) if not isinstance(a, tuple) else \
        (a[0], a[1], "c128" if isinstance(a[0], F64Bits) else "c64")
    b_re, b_im, kind_b = _canon_complex(b) if not isinstance(b, tuple) else \
        (b[0], b[1], "c128" if isinstance(b[0], F64Bits) else "c64")
    m, k = a_re.shape
    k2, n = b_re.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {a_re.shape} x {b_re.shape}")
    if k > _KMAX[compute_type]:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound for {compute_type}")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    if m % nx or k % ny or n % ny or n % nx:
        raise ValueError(f"shapes ({m},{k},{n}) must divide mesh {nx}x{ny}")
    is64a = isinstance(a_re, F64Bits)
    is64b = isinstance(b_re, F64Bits)
    out_kind = out_dtype or ("f64" if "c128" in (kind_a, kind_b) else "f32")
    fn = _build_sharded_complex(mesh, num_moduli, out_kind, is64a, is64b,
                                compute_type)
    pa = _sharding_for(mesh, P("x", "y"), is64a)
    pb = _sharding_for(mesh, P("y", "x"), is64b)
    return fn(jax.device_put(a_re, pa), jax.device_put(a_im, pa),
              jax.device_put(b_re, pb), jax.device_put(b_im, pb))


def _sharding_for(mesh, spec, is_f64: bool):
    ns = NamedSharding(mesh, spec)
    if is_f64:
        return F64Bits(ns, ns)
    return ns
