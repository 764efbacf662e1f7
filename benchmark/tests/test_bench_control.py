"""The control (the reference in the program's place, its SW scores in
8-bit saturating arithmetic) fails each configuration's check, at a size a
test run holds. On the card it runs at the cells' size:
python3 benchmark/control.py --workload <name> --seeds ..."""
import pytest

from benchmark.control import control_numbers
from benchmark.tests._tiny import BENCH, tiny


@pytest.mark.parametrize("workload", ["sprot_gpu.proteome",
                                      "sprot_gpu_gapped.proteome"])
@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_control_is_called_wrong(workload, seed):
    # long enough that family hits score past the byte range
    cfg, traffic = tiny(workload, entries=150, length_mean=250)
    numbers, correct = control_numbers(BENCH, workload, seed, "cpu",
                                       cfg=cfg, traffic=traffic)
    assert not correct, numbers


@pytest.mark.parametrize("workload", ["sprot_gpu.proteome",
                                      "sprot_gpu_gapped.proteome"])
def test_unsaturated_control_passes(workload):
    # the same path at full precision is the reference itself
    cfg, traffic = tiny(workload, entries=150, length_mean=250)
    numbers, correct = control_numbers(BENCH, workload, 5, "cpu", sat=10**8,
                                       cfg=cfg, traffic=traffic)
    assert correct, numbers
