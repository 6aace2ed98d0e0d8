"""The port's calibration registries equal the reference's, field by
field, and `interop` carries a custom technology / scheme across."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import calibration as ref_cal  # noqa: E402
from repro.core import routing as ref_routing  # noqa: E402
from repro.core import space as ref_space  # noqa: E402
from repro.core import units as ref_units  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import calibration as cal  # noqa: E402
from repro_torch.core import routing, space, units  # noqa: E402


def _constants(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and isinstance(v, (int, float, str, tuple))}


@pytest.mark.parametrize("name", list(ref_cal.TECHS))
def test_tech_equals_reference(name):
    assert dataclasses.asdict(cal.get_tech(name)) == dataclasses.asdict(
        ref_cal.get_tech(name))


@pytest.mark.parametrize("name", list(ref_routing.SCHEMES))
def test_scheme_equals_reference(name):
    assert dataclasses.asdict(routing.scheme_spec(name)) == dataclasses.asdict(
        ref_routing.scheme_spec(name))


def test_registry_order_equals_reference():
    """Sweep row order follows registry insertion order."""
    assert list(cal.TECHS) == list(ref_cal.TECHS)
    assert list(routing.SCHEMES) == list(ref_routing.SCHEMES)


@pytest.mark.parametrize("port_mod,ref_mod", [(cal, ref_cal),
                                              (units, ref_units),
                                              (space, ref_space)],
                         ids=["calibration", "units", "space"])
def test_module_constants_equal_reference(port_mod, ref_mod):
    assert _constants(port_mod) == _constants(ref_mod)


def test_tech_from_fields_round_trips_a_custom_tech():
    custom = dataclasses.replace(ref_cal.AOS, name="aos_interop",
                                 r_on_cell_kohm=480.0, layer_grid=(64, 96),
                                 allowed_schemes=("sel_strap",))
    fields = dataclasses.asdict(custom)
    try:
        ref_cal.register_tech(custom)
        tech = interop.tech_from_fields(fields)
        assert cal.get_tech("aos_interop") is tech
        assert dataclasses.asdict(tech) == fields
        # the custom tech lowers to the same rows on both sides
        ref_sp = ref_space.DesignSpace.product(techs=("aos_interop",)).lower()
        sp = space.DesignSpace.product(techs=("aos_interop",)).lower(
            device="cpu")
        assert sp.scheme_names == ref_sp.scheme_names == ("sel_strap",)
        assert sp.layers_np.tolist() == ref_sp.layers_np.tolist() == [64, 96]
        with pytest.raises(ValueError, match="already registered"):
            interop.tech_from_fields(fields)
    finally:
        ref_cal.unregister_tech("aos_interop")
        cal.unregister_tech("aos_interop")


def test_scheme_from_fields_round_trips_a_custom_scheme():
    spec = dataclasses.replace(ref_routing.scheme_spec("strap"),
                               name="strap8", straps_per_global=8)
    fields = dataclasses.asdict(spec)
    try:
        made = interop.scheme_from_fields(fields)
        assert routing.scheme_spec("strap8") is made
        assert dataclasses.asdict(made) == fields
    finally:
        routing.unregister_scheme("strap8")
