"""The precision controls on the card: the plain reference computed in
TF32, throughout or in its backward pass alone, in the program's place
must come out as not correct against the fp32 reference, at
inat.gaia.multigraph's own size. Needs a CUDA card; skips without one."""

import pytest
import torch

from bench import check, harness
from bench.reference import fl as reffl


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("precision", ["tf32", "tf32_backward"])
def test_precision_control_is_not_correct(precision, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = harness.load_cell("inat.gaia.multigraph")
    ref = reffl.run(cell.cfg, cell.traffic, seed, device="cuda",
                    check_rounds=cell.check_rounds)
    low = reffl.run(cell.cfg, cell.traffic, seed, device="cuda",
                    check_rounds=cell.check_rounds, precision=precision)
    numbers = check.compare(low, ref, cell.check_rounds)
    assert not check.judge(numbers, cell.limits), numbers
