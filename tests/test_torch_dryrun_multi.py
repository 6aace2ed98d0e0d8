"""Every smoke config runs every runnable cell through the port's dry run
on the fake "multi" production mesh, 2 x 16 x 16 over ("pod", "data",
"model"), 512 ranks: `ok`, FLOPs > 0, the arguments below the peak, the
parameters gathered (see `torch_dryrun_cells.py` for the sizes)."""

import pytest

pytest.importorskip("torch")

from repro_torch.configs.registry import list_archs  # noqa: E402

from torch_dryrun_cells import check_every_cell  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_every_cell_on_the_multi_mesh(arch):
    check_every_cell(arch, "multi")
