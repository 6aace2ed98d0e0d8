"""The port's host-to-device conversions (`repro_torch.device`), on the CPU.

Scalars are built on the device with no copy from the host (`scalar_f32`,
the scalar branches of `as_f32` / `as_bool`, `rdiv`'s numerator); they must
hold exactly the float32 that `torch.tensor(x, dtype=torch.float32)` holds,
and dividing by them must be one correctly rounded float32 division (numpy's
float32 division is the reference).  Arrays keep their copy and their values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import transient  # noqa: E402
from repro_torch.device import as_bool, as_f32, rdiv, scalar_f32  # noqa: E402

SCALARS = [1.0 / 3.0, 0.1, 0.02, 5e-3, 1e-40, 3.4e38, 1e39, -0.0, 0.0,
           -2.5, np.float64(0.7), np.float32(0.7), 7, 2 ** 60 + 1, True,
           np.int32(-3), float("inf"), float("-inf")]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.int32)


@pytest.mark.parametrize("x", SCALARS, ids=repr)
@pytest.mark.parametrize("build", [scalar_f32, as_f32],
                         ids=["scalar_f32", "as_f32"])
def test_scalar_is_the_float32_of_torch_tensor(build, x):
    got = build(x, "cpu")
    want = torch.tensor(x, dtype=torch.float32)
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(bits(got), bits(want))


def test_scalar_nan():
    assert torch.isnan(scalar_f32(float("nan"), "cpu"))
    assert torch.isnan(as_f32(np.float64("nan"), "cpu"))


@pytest.mark.parametrize("x", [True, False, 0, 3, np.bool_(True), 0.0, -0.5])
def test_as_bool_scalar(x):
    got = as_bool(x, "cpu")
    assert got.shape == () and got.dtype == torch.bool
    assert bool(got) == bool(x)


def test_arrays_keep_their_values():
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(5, 3)) * 10.0 ** rng.integers(-30, 30, (5, 3))
    want = bits(torch.as_tensor(arr.astype(np.float32)))
    assert torch.equal(bits(as_f32(arr, "cpu")), want)
    assert torch.equal(bits(as_f32(arr, "cpu", non_blocking=True)), want)
    assert torch.equal(as_f32([87, 137], "cpu"), torch.tensor([87.0, 137.0]))
    mask = rng.integers(0, 2, 7).astype(bool)
    assert torch.equal(as_bool(mask, "cpu"), torch.as_tensor(mask))


@pytest.mark.parametrize("divisor", [3.0, 0.02, 7e-3, 1.0 / 3.0, 1e-30])
def test_division_by_a_device_scalar_is_a_true_division(divisor):
    rng = np.random.default_rng(1)
    x = (rng.uniform(-10, 10, 4096) * 10.0 ** rng.integers(-5, 5, 4096)
         ).astype(np.float32)
    got = torch.from_numpy(x) / scalar_f32(divisor, "cpu")
    want = x / np.float32(divisor)
    assert torch.equal(bits(got), bits(torch.from_numpy(want)))
    # rdiv: the numerator as a device scalar, one rounding
    r = rdiv(divisor, torch.from_numpy(x))
    assert torch.equal(bits(r), bits(torch.from_numpy(np.float32(divisor) / x)))


def test_step_index_and_crossing_use_true_division():
    """The phased engine's event-time helpers divide by DT as float32."""
    t_ns = torch.tensor([0.02, 0.06, 0.1, 15.98, float("nan")])
    idx = transient._step_index(t_ns, transient.T_ACT_NS,
                                transient.N_ACT_STEPS)
    finite = t_ns.numpy()[:-1]
    want = (finite / np.float32(transient.DT_NS)).astype(np.int32) - 1
    want = np.clip(want, 0, transient.N_ACT_STEPS - 1).tolist()
    assert idx.tolist() == want + [transient.N_ACT_STEPS - 1]
    crossed = torch.zeros((5, 3), dtype=torch.bool)
    crossed[2, 0] = crossed[4, 1] = True
    t = transient._first_crossing_ns(crossed, transient.DT_NS)
    assert t[0].item() == np.float32(3) * np.float32(transient.DT_NS)
    assert t[1].item() == np.float32(5) * np.float32(transient.DT_NS)
    assert torch.isnan(t[2])
