"""Check, exhaustively, the quotient sequence of `csrc/rc_multistep.cu`.

    python src/repro_torch/kernels/quotient_check.py [--dmax 16]

The kernel divides a by b as

    y = RN(1/b);  q0 = RN(a*y);  r = fma(-q0, b, a);  q = fma(r, y, q0)

and must return RN(a/b), the IEEE binary32 quotient, bit for bit.  The
value that the last fma rounds is within 3*2^-24 ulp of a/b (q0 is within
1.5 ulp of a/b, y within 2^-24 of 1/b relative, r rounded at most once), so
q can differ from RN(a/b) only where a/b lies that close to a rounding
midpoint m: |a*2^k - m*b| <= 16 in the units of a's and b's significands.
Exponents scale out (the kernel's guard keeps y, q0, r and q clear of
underflow and overflow), so the check runs over significands: every b in
[2^23, 2^24), and for each the a whose quotient lies within `dmax` units of
a midpoint, found by a modular inverse, in both binades of the quotient's
significand ([1/2, 1) and [1, 2)).  Each candidate is evaluated in exact
integer arithmetic; the reciprocal, the first product and the reference
quotient are also checked against numpy's float32 arithmetic.

`check(...)` returns the count of candidates, of q0 off by one ulp or more,
and of quotients that differ from RN(a/b) with no correction (q0 itself)
and after the correction.  The whole run (1.19e8 candidates at dmax = 16) takes about a minute
and ~0.7 GB on one CPU core.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

SIG = 24                         # binary32 significand bits
_ONE = np.int64(1)


def _rne_shift(num: np.ndarray, sh: int) -> np.ndarray:
    """num / 2**sh rounded to nearest, ties to even (int64, sh >= 1)."""
    fl = num >> sh
    rem = num - (fl << sh)
    half = _ONE << (sh - 1)
    return fl + ((rem > half) | ((rem == half) & ((fl & 1) == 1)))


def _rn_sig(x: np.ndarray) -> np.ndarray:
    """Integers x rounded to SIG significant bits (ties to even), in place
    of their value: what a float32 holds of x times a power of two."""
    out = x.copy()
    ax = np.abs(x)
    for k in range(1, 32):
        m = (ax >= (_ONE << (SIG + k - 1))) & (ax < (_ONE << (SIG + k)))
        if m.any():
            out[m] = np.sign(x[m]) * (_rne_shift(ax[m], k) << k)
    return out


def _inv_mod(odd: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of odd integers modulo 2**bits (Newton's iteration)."""
    x = odd.copy()
    mask = (_ONE << bits) - 1
    for _ in range(5):
        x = (x * ((2 - odd * x) & mask)) & mask
    return x


def _correct(q, qn, b, y):
    """The correction: RN(q + RN(a - q*b) * y) in units of the quotient's
    ulp, with a*2^k = qn (exact integers)."""
    rr = _rn_sig(qn - b * q)
    num = rr * y
    fl = num >> 47
    rem = num - (fl << 47)
    half = _ONE << 46
    return q + fl + ((rem > half) | ((rem == half) & (((q + fl) & 1) == 1)))


def _evaluate(a, b, y, binade, stats, spot_check):
    # quotient ulp: 2^-24 in [1/2, 1), 2^-23 in [1, 2) (a, b integers)
    ush = 24 if binade == 0 else 23
    qn = a << ush
    ref = qn // b
    ref = ref + (2 * (qn - ref * b) > b)         # no quotient is a midpoint
    q0 = _rne_shift(a * y, 47 - ush)
    if spot_check:
        af, bf = a[:2000].astype(np.float32), b[:2000].astype(np.float32)
        yf = np.float32(1) / bf
        assert (yf.astype(np.float64) == y[:2000] * 2.0 ** -47).all()
        assert ((af * yf).astype(np.float64) == q0[:2000] * 2.0 ** -ush).all()
        assert ((af / bf).astype(np.float64) == ref[:2000] * 2.0 ** -ush).all()
    q1 = _correct(q0, qn, b, y)
    lo, hi = _ONE << 23, _ONE << 24
    edge = (q0 < lo) | (q0 > hi) | (q1 < lo) | (q1 >= hi)
    stats["candidates"] += int(a.size)
    stats["edge"] += int(edge.sum())
    stats["q0_off_one_ulp"] += int((np.abs(qn - b * q0) >= b).sum())
    stats["no_correction_wrong"] += int(((q0 != ref) & ~edge).sum())
    stats["one_correction_wrong"] += int(((q1 != ref) & ~edge).sum())


def check(dmax: int = 16, b_lo: int = 1 << 23, b_hi: int = 1 << 24,
          step: int = 1) -> dict:
    """Run the check over the divisor significands range(b_lo, b_hi, step);
    returns the counts by binade of the quotient's significand."""
    b_all = np.arange(b_lo, b_hi, step, dtype=np.int64)
    tz = np.zeros_like(b_all)
    t = b_all.copy()
    while ((t & 1) == 0).any():
        even = (t & 1) == 0
        tz[even] += 1
        t[even] >>= 1
    out = {}
    for binade in (0, 1):
        # midpoints m*2^-mod_bits with m odd in [2^24, 2^25): a quotient
        # a/b = (m*b + delta) / (b * 2^mod_bits)
        mod_bits = 25 if binade == 0 else 24
        stats = dict(candidates=0, edge=0, q0_off_one_ulp=0,
                     no_correction_wrong=0, one_correction_wrong=0)
        spot = True
        for k in range(0, 5):                 # b = 2^k * odd b'
            b = b_all[tz == k]
            if b.size == 0:
                continue
            inv = _inv_mod(b >> k, mod_bits - k)
            y = (_ONE << 47) // b                 # y = RN(1/b) * 2^47
            rem = (_ONE << 47) - y * b
            y = y + ((2 * rem > b) | ((2 * rem == b) & ((y & 1) == 1)))
            modk = _ONE << (mod_bits - k)
            for delta in range(-dmax, dmax + 1):
                if delta == 0 or delta % (1 << k):
                    continue
                m0 = ((-(delta >> k)) % modk * inv) % modk
                for j in range(1 << (k + 1)):
                    m = m0 + j * modk
                    ok = (m >= (1 << 24)) & (m < (1 << 25)) & ((m & 1) == 1)
                    if not ok.any():
                        continue
                    a = (m[ok] * b[ok] + delta) >> mod_bits
                    keep = ((a < b[ok]) & (2 * a >= b[ok]) if binade == 0
                            else (a >= b[ok]) & (a < 2 * b[ok]))
                    keep &= (a > 0) & (a < (1 << 24))
                    if keep.any():
                        _evaluate(a[keep], b[ok][keep], y[ok][keep], binade,
                                  stats, spot)
                        spot = False
        out["quotient_in_[0.5,1)" if binade == 0 else "quotient_in_[1,2)"] = stats
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dmax", type=int, default=16,
                    help="largest |a*2^k - m*b| checked (16 covers the bound)")
    args = ap.parse_args(argv)
    res = check(args.dmax)
    print(json.dumps(res))
    wrong = sum(s["one_correction_wrong"] + s["edge"] for s in res.values())
    return 1 if wrong else 0


if __name__ == "__main__":
    raise SystemExit(main())
