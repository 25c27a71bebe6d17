"""Direct contract tests for the packed limb helpers (core.limbs).

The reconstruct rounding chain depends on shift_right_round returning the
exact (shifted limbs, round bit, sticky) triple, including the static
pre_zero_limbs pre-shift introduced for the one-funnel rounding path —
these tests pin the bit-level contract against big-int arithmetic."""

import random

import jax.numpy as jnp
import numpy as np

from gemmul8_tpu.core import limbs as lb


def _to_limbs(vals, n):
    return [jnp.asarray([(v >> (16 * i)) & 0xFFFF for v in vals],
                        jnp.int32) for i in range(n)]


def _from_limbs(arrs):
    # python-int assembly: limb counts here exceed 64 bits
    cols = [np.asarray(a) for a in arrs]
    out = [0] * len(cols[0])
    for i, c in enumerate(cols):
        for j in range(len(out)):
            out[j] |= int(c[j]) << (16 * i)
    return out


def test_shift_right_round_matches_bigint():
    rng = random.Random(7)
    for pre in (0, 2, 4):
        nl = 7
        n_out = 5
        vals, us = [], []
        for _ in range(256):
            v = rng.getrandbits(rng.randrange(1, 16 * nl + 1))
            u = rng.randrange(0, 16 * (nl + pre + 1) + 1)
            vals.append(v)
            us.append(u)
        # boundary shifts: 0, 1, exact pre-shift, everything-out
        for v in (1, (1 << (16 * nl)) - 1, 0x8000_0000_0000):
            for u in (0, 1, 16 * pre, 16 * pre + 1, 16 * (nl + pre + 1)):
                vals.append(v)
                us.append(u)
        limbs = _to_limbs(vals, nl)
        u_arr = jnp.asarray(us, jnp.int32)
        sh, rbit, sticky = lb.shift_right_round(limbs, u_arr, n_out,
                                                pre_zero_limbs=pre)
        got = _from_limbs(sh)
        rb = np.asarray(rbit)
        st = np.asarray(sticky)
        for i, (v, u) in enumerate(zip(vals, us)):
            vp = v << (16 * pre)
            exp_sh = (vp >> u) & ((1 << (16 * n_out)) - 1)
            exp_rb = (vp >> (u - 1)) & 1 if u > 0 else 0
            exp_st = (vp & ((1 << max(u - 1, 0)) - 1)) != 0
            assert got[i] == exp_sh, (i, v, u, pre, hex(got[i]), hex(exp_sh))
            assert rb[i] == exp_rb, (i, v, u, pre)
            assert bool(st[i]) == exp_st, (i, v, u, pre)


def test_mod_m_centered_redundant_and_canonical():
    """_mod_m_centered must return the exact centered representative for
    both canonical and redundant (< 2^29 per limb) inputs across the
    quotient range the CRT accumulation can produce."""
    from gemmul8_tpu import tables
    from gemmul8_tpu.core import reconstruct as rec

    rng = random.Random(11)
    for L in (2, 8, 14, 20):
        mm = tables.big_m(L)
        nl = tables.num_limbs(L)
        xs = []
        for _ in range(128):
            t = rng.randrange(0, 255 * L + 1)
            r = rng.randrange(0, mm)
            xs.append(t * mm + r if t * mm + r < 255 * L * mm else r)
        xs += [0, 1, mm // 2, mm // 2 + 1, mm - 1, mm, mm + 1,
               255 * L * mm - 1]
        # canonical limbs
        limbs = _to_limbs(xs, nl)
        mag, neg = rec._mod_m_centered(limbs, L)
        got = _from_limbs(mag)
        ng = np.asarray(neg)
        for i, x in enumerate(xs):
            r = x % mm
            exp = r if r <= mm // 2 else mm - r
            exp_neg = r > mm // 2
            assert got[i] == exp and bool(ng[i]) == exp_neg, (L, i, x)
        # redundant limbs: split each 16-bit limb value plus spill from a
        # random redistribution bounded by 2^29 per limb
        red = []
        for l in range(nl):
            red.append([(x >> (16 * l)) & 0xFFFF for x in xs])
        for i in range(len(xs)):
            if i % 2:
                # adversarial redistribution: push each limb AS CLOSE TO
                # the documented 2^29 redundant bound as the limb above
                # can fund — a carry-free digit assembly's contract
                # (_crt_accumulate_mxu limb sums < 2^29) and the quotient
                # budget (t - t_est < 1.5) are sized for exactly this
                for l in range(nl - 1):
                    k = min(red[l + 1][i],
                            ((1 << 29) - 1 - red[l][i]) >> 16)
                    red[l + 1][i] -= k
                    red[l][i] += k << 16
                    assert red[l][i] < (1 << 29)
            else:
                # random moderate redistribution
                for l in range(nl - 1):
                    k = rng.randrange(0, 1 << 12)
                    if red[l + 1][i] >= k:
                        red[l + 1][i] -= k
                        red[l][i] += k << 16
        # at least one vector must actually sit at the bound's edge for
        # the large-M counts (for L=2 the VALUE itself is < 2^26, so no
        # redistribution can reach 2^29 — the bound is unreachable there)
        if mm > (1 << 32):
            assert max(red[l][i] for l in range(nl - 1)
                       for i in range(len(xs))) >= (1 << 29) - (1 << 17), \
                "redistribution failed to reach the 2^29 bound"
        limbs_r = [jnp.asarray(r, jnp.int32) for r in red]
        mag2, neg2 = rec._mod_m_centered(limbs_r, L)
        got2 = _from_limbs(mag2)
        ng2 = np.asarray(neg2)
        for i, x in enumerate(xs):
            r = x % mm
            exp = r if r <= mm // 2 else mm - r
            exp_neg = r > mm // 2
            assert got2[i] == exp and bool(ng2[i]) == exp_neg, (L, i, x)
