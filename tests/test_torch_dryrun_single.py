"""Every smoke config runs every runnable cell through the port's dry run
on the fake "single" production mesh, 16 x 16 over ("data", "model"),
256 ranks: `ok`, FLOPs > 0, the arguments below the peak, the parameters
gathered (see `torch_dryrun_cells.py` for the sizes)."""

import pytest

pytest.importorskip("torch")

from repro_torch.configs.registry import list_archs  # noqa: E402

from torch_dryrun_cells import check_every_cell  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_every_cell_on_the_single_mesh(arch):
    check_every_cell(arch, "single")
