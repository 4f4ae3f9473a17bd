"""The control: the reference computed with TF32 on, the precision just
below the configurations', in the program's place, is not correct under
the tiny cells' limits.  On the card only (TF32 exists nowhere else);
the full-size readings are ``python3 gcbench/control.py``'s."""

import pytest

from gcbench import compare, control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny_rest.train", "tiny_bldg.train",
                                  "tiny_city.frame", "tiny_rest.frame",
                                  "tiny_rest.train.ddp2"])
def test_the_control_fails_a_limit(tiny_root, card, name):
    harness.set_environment(tiny_root)
    cell = harness.find_cell(tiny_root, name)
    fn = control.CONTROLS[cell.traffic["kind"]]
    correct, compared = compare.judge(fn(cell, 13, card), cell.limits)
    assert correct is False, compared
