"""The quotient sequence of the rc_multistep kernel, checked on the CPU.

`csrc/rc_multistep.cu` divides as y = RN(1/b), q0 = RN(a*y),
q = fma(fma(-q0, b, a), y, q0) and must match IEEE float32 division bit for
bit.  `kernels/quotient_check.py` evaluates that sequence in exact integer
arithmetic over every significand pair whose quotient lies close enough to a
rounding midpoint to round the other way; here it runs on a sample of the
divisors (the whole run takes about a minute).
"""

import numpy as np
import pytest

from repro_torch.kernels import quotient_check


@pytest.mark.parametrize("b_lo,step", [(1 << 23, 4099), ((1 << 23) + 1, 8191),
                                       ((1 << 24) - 40000, 37)],
                         ids=["wide", "odd", "top"])
def test_one_correction_rounds_as_ieee_division(b_lo, step):
    res = quotient_check.check(dmax=16, b_lo=b_lo, b_hi=1 << 24, step=step)
    assert sum(s["candidates"] for s in res.values()) > 5000
    for binade, stats in res.items():
        assert stats["candidates"] > 0, binade
        assert stats["edge"] == 0, binade
        assert stats["one_correction_wrong"] == 0, (binade, stats)
    # near midpoints the uncorrected product often rounds the other way,
    # so the check can see a wrong sequence
    assert sum(s["no_correction_wrong"] for s in res.values()) > 100


def test_emulation_matches_float32_arithmetic():
    """The exact-integer pieces agree with numpy's IEEE float32 on random
    significands: y = RN(1/b), q0 = RN(a*y) and RN(a/b)."""
    rng = np.random.default_rng(0)
    b = rng.integers(1 << 23, 1 << 24, 20000, dtype=np.int64)
    a = rng.integers(1 << 23, 1 << 24, 20000, dtype=np.int64)
    y = (np.int64(1) << 47) // b
    rem = (np.int64(1) << 47) - y * b
    y = y + (2 * rem > b)
    assert ((np.float32(1) / b.astype(np.float32)).astype(np.float64)
            == y * 2.0 ** -47).all()
    lo = a < b                     # quotient significand in [1/2, 1)
    ush = np.where(lo, 24, 23)
    q0 = np.array([quotient_check._rne_shift(np.array([ai * yi]), 47 - u)[0]
                   for ai, yi, u in zip(a[:500], y[:500], ush[:500])])
    prod = a[:500].astype(np.float32) * (np.float32(1) / b[:500].astype(np.float32))
    assert (prod.astype(np.float64) == q0 * 2.0 ** -ush[:500]).all()
