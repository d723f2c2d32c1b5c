"""The control (the reference one precision step below float32: the DFT in
TF32, the kurtosis moments and the search in bfloat16) fails the
comparison's limits at the CPU's tiny geometry, as it does on the card at
the cells' own (`test_portbench_card`)."""

from portbench import control
from portbench.tests._tiny import tiny_cell


def test_control_fails_the_limits():
    cell = tiny_cell()
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        vals = control.control_numbers(cell, seed, "cpu")
        failed = [n for n in vals if vals[n] > cell.limits[n]]
        assert failed, vals
