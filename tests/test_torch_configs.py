"""The port's ten architecture configs and their input specs against the
JAX reference, on the CPU.

Bars: equal.  Every config, full and `-smoke`, field by field
(`dataclasses.asdict`), with its derived properties, parameter counts and
runnable cells; `input_specs` for every config and cell, shapes and
dtypes (the port's meta tensors against the reference's
`ShapeDtypeStruct`s).
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import registry as JM  # noqa: E402
from repro_torch.configs import base, registry  # noqa: E402
from repro_torch.models import registry as M  # noqa: E402

NAMES = sorted(jreg.ARCHS)
SIZES = {"full": "", "smoke": "-smoke"}
CELLS = sorted(jbase.SHAPE_CELLS) + ["smoke"]
PROPS = ("head_dim_", "padded_vocab", "d_inner", "ssm_nheads",
         "attention_free", "sub_quadratic")


def test_registry_lists_the_reference_configs():
    assert registry.list_archs() == jreg.list_archs() == NAMES
    assert len(NAMES) == 10
    assert sorted(registry.ARCHS) == NAMES


@pytest.mark.parametrize("name", ["nope", "nope-smoke", "qwen2", "-smoke"])
def test_unknown_name_raises_key_error(name):
    with pytest.raises(KeyError):
        registry.get_arch(name)
    with pytest.raises(KeyError):
        jreg.get_arch(name)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_reference(name, size):
    ours = registry.get_arch(name + SIZES[size])
    theirs = jreg.get_arch(name + SIZES[size])
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in PROPS:
        assert getattr(ours, prop) == getattr(theirs, prop), prop
    assert ours.param_count() == theirs.param_count()
    assert ours.active_param_count() == theirs.active_param_count()
    assert ours.runnable_cells() == theirs.runnable_cells()
    if not SIZES[size]:
        assert registry.get_arch(name) is registry.ARCHS[name]


def test_config_modules_export_config():
    """Each config module's `CONFIG` is the reference's, field by field."""
    for mod in ("arctic_480b", "deepseek_67b", "mamba2_780m", "olmo_1b",
                "phi35_moe", "pixtral_12b", "qwen15_110b", "qwen2_1_5b",
                "whisper_tiny", "zamba2_7b"):
        ours = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        theirs = importlib.import_module(f"repro.configs.{mod}").CONFIG
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), mod


def spec_of(x):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(x, torch.Tensor):
        assert x.device.type == "meta"
        return tuple(x.shape), str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), np.dtype(x.dtype).name


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("name", NAMES)
def test_input_specs_equal_reference(name, size, cell):
    """Where the reference's spec has a negative dim (full Pixtral's 256
    vision tokens in the 128-token smoke cell), the port raises."""
    theirs = jbase.input_specs(jreg.get_arch(name + SIZES[size]), cell)
    cfg = registry.get_arch(name + SIZES[size])
    if min(min(v.shape) for v in theirs.values()) < 0:
        assert (name, size, cell) == ("pixtral-12b", "full", "smoke")
        with pytest.raises(ValueError, match="vision tokens"):
            base.input_specs(cfg, cell)
        return
    ours = base.input_specs(cfg, cell)
    assert list(ours) == list(theirs)
    assert {k: spec_of(v) for k, v in ours.items()} == {
        k: spec_of(v) for k, v in theirs.items()}


@pytest.mark.parametrize("cell", sorted(jbase.SHAPE_CELLS))
def test_cell_batch_seq(cell):
    assert base.cell_batch_seq(cell) == jbase.cell_batch_seq(cell)
    with pytest.raises(KeyError):
        base.cell_batch_seq("smoke")


def test_input_specs_allocate_nothing():
    """The full Qwen1.5-110B prefill cell's specs are meta tensors: shapes
    and dtypes, no storage."""
    specs = base.input_specs(registry.get_arch("qwen1.5-110b"), "prefill_32k")
    assert all(t.is_meta for t in specs.values())
    assert specs["tokens"].shape == (32, 32_768)
    assert specs["tokens"].dtype == torch.int32


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_cache_schema_equals_reference(name, gated):
    """The decode cache's shapes and axes, for each config, with and
    without the gated decode (`ksum`).  The gated flag applies to the
    attention families only: an ssm or hybrid config with it takes its
    own cache, as in the reference, and enc-dec its own."""
    change = dict(strap_decode=gated, decode_strap_tokens=256)
    ours = M.cache_schema(dataclasses.replace(registry.get_arch(name),
                                              **change), 8, 4096)
    theirs = JM.cache_schema(dataclasses.replace(jreg.get_arch(name),
                                                 **change), 8, 4096)
    assert {k: (v.shape, v.axes) for k, v in ours.items()} == {
        k: (v.shape, v.axes) for k, v in theirs.items()}
    cfg = registry.get_arch(name)
    assert ("ksum" in ours) == (gated and cfg.family in ("dense", "moe",
                                                         "vlm"))
    assert ("ssm" in ours) == (cfg.family in ("ssm", "hybrid"))
    assert ("xk" in ours) == cfg.is_encdec
