"""A run whose timed path is broken underneath reads ``correct`` false:
the harness is driven on the CPU at tiny sizes past its look for a card,
once for each fault these cells can have (``gcbench/faults.py``).  The
one-chip cells run one sample a step, so no exchange between chips can
be left out; half of a sample's points stands in for half of a batch.
The data-parallel cell's ranks are processes of their own, which plant
the fault that ``faults.ENV`` names."""

import pytest

from gcbench import faults
from gcbench.tests import tiny

CASES = ([(c, f) for c in ("tiny_rest.train", "tiny_bldg.train")
          for f in faults.TRAIN]
         + [(c, f) for c in ("tiny_rest.frame", "tiny_city.frame",
                             "tiny_kitti.frame")
            for f in faults.FRAME]
         + [("tiny_rest.train.ddp2", f) for f in
            [*faults.DDP, "unchanged", "altered_crop"]])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    faults.ALL[fault](monkeypatch.setattr)
    monkeypatch.setenv(faults.ENV, fault)
    result, compared = tiny.run(tiny_root, cell, seed=11)
    assert result["correct"] is False, compared
