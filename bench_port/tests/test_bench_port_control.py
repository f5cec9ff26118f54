"""The control of the correctness check comes out not correct: the plain
reference in TF32 (float32 with the operands of every matrix product
rounded to TF32), put in the program's place, fails the cell's limits,
while the program passes them.  On the CPU at a tiny size; on the chip at
the cell's own size, on three seeds."""
import pytest

import check
import control

from conftest import ROOT


def judged(readings):
    return (check.judge(readings["program"], readings["limits"])[0],
            check.judge(readings["control"], readings["limits"])[0])


def test_control_fails_tiny(tiny_root):
    r = control.readings("tmap.stream", 2147483701, 0.5, device="cpu",
                         root=tiny_root, search=[tiny_root])
    assert judged(r) == (True, False), r


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["map53m.stream"])
def test_control_fails_on_chip(chip, workload):
    for seed in (3100000001, 3100000002, 3100000003):
        r = control.readings(workload, seed, 2.0, root=ROOT)
        assert judged(r) == (True, False), r
