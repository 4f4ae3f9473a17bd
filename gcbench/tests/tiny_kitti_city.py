"""A tiny KITTI-360-shaped city for the harness's tests, written into the
tiny benchmark as ``gcbench/cities/tiny_kitti.py``: the synthetic city's
roads and box buildings, and cars on the roads near its centre, whose
instances start at 10000 (KITTI-360's car range, class 3)."""

import numpy as np

from gcbench import inputs

CAR_ID0 = 10000
CAR_CLASS = 3


def build(city: dict):
    P = city["size"]
    projections, _ = inputs.synthetic_city(P, city["n_buildings"],
                                           city["seed"])
    r = projections["REST"]
    ins, td, seg = r["INS"], r["TD_HF"], r["SEG"]
    rng = np.random.default_rng(city["seed"] + 1)
    placed = 0
    while placed < city["n_cars"]:
        x, y = rng.integers(P // 4, 3 * P // 4, 2)
        box = np.s_[y:y + 2, x:x + 4]
        if (ins[box] == 1).all():
            ins[box] = CAR_ID0 + placed
            td[box] = 3
            seg[box] = CAR_CLASS
            placed += 1
    return projections, inputs.instance_centers(ins, td)
