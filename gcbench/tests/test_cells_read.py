"""What the cells of ``BENCHMARK.json`` that read only the Google Earth
synthetic city read is pinned: the weight tag of each generator and the
weights a tag draws, a digest of the city and of the orbit, and the
Google Earth class scales that their reference extrudes with.  The
digests were taken before configurations could carry further generators
and traffic files could name a city builder, so these cells read what
they read then."""

import hashlib
import json

import numpy as np
import pytest
import torch

from gcbench import harness, inputs, weights
from gcbench.kinds import frame
from gcbench.reference import frame as ref_frame
from gcbench.reference.gct.ops import extrusion as ext
from gcbench.tests import tiny

SEED = 2 ** 31 + 77
GE_512, GE_2048, ORBIT = "9c2e60d66ad907ff", "ac3b217a8a548a78", \
    "d68569081a15f1df"
PINNED = {
    "bldg.train": {"city": GE_512, "orbit": None, "tags": None},
    "rest.train": {"city": GE_2048, "orbit": None, "tags": None},
    "city.frame": {"city": GE_512, "orbit": ORBIT,
                   "tags": {"REST": 10, "BLDG": 11}},
    "rest.frame": {"city": GE_512, "orbit": ORBIT, "tags": {"REST": 10}},
}
# the weights each tag draws, on tiny stand-ins of the generators
DRAWS = {"REST": "02dfb352f8cd3c47", "BLDG": "593fe78c82472305",
         "train": "bdb42b53da3e879f"}


def digest(obj) -> str:
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, np.ndarray):
            h.update(f"{x.dtype}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, torch.Tensor):
            walk(x.detach().cpu().numpy())
        else:
            h.update(repr(x).encode())

    walk(obj)
    return h.hexdigest()[:16]


def reads(name: str) -> dict:
    cell = harness.find_cell(tiny.REPO, name)
    if cell.traffic["kind"] != "frame":
        city = inputs.city_from(cell.traffic, cell.root)
        return {"city": digest(city), "orbit": None, "tags": None}
    plan = frame.Plan(cell, SEED)
    return {"city": digest((plan.projections, plan.centers)),
            "orbit": digest(plan.poses),
            "tags": {k: frame.MODEL_TAGS[k] for k in plan.confs}}


def draws() -> dict:
    rest, bldg = tiny.tiny_rest(), tiny.tiny_bldg()
    return {
        "REST": digest(weights.generator_model(
            rest, SEED, frame.MODEL_TAGS["REST"], "cpu").state_dict()),
        "BLDG": digest(weights.generator_model(
            bldg, SEED, frame.MODEL_TAGS["BLDG"], "cpu").state_dict()),
        "train": digest({k: m.state_dict() for k, m in
                         weights.train_models(rest, SEED, "cpu").items()})}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_a_google_earth_cell_reads_what_it_read(name):
    assert reads(name) == PINNED[name]
    cell = harness.find_cell(tiny.REPO, name)
    confs = [cell.config, *cell.companions.values()]
    for conf in confs:
        ds = weights.reference_config(conf).dataset
        assert ref_frame.class_scales(ds) == ext.GOOGLE_EARTH_CLASS_SCALES


def test_each_tag_draws_the_weights_it_drew():
    assert draws() == DRAWS


def test_no_two_seed_streams_share_a_tag():
    tags = [*frame.MODEL_TAGS.values(), frame.STYLE_TAG]
    assert len(set(tags)) == len(tags)
    assert frame.MODEL_TAGS["CAR"] == 13


if __name__ == "__main__":
    print(json.dumps({"PINNED": {n: reads(n) for n in sorted(PINNED)},
                      "DRAWS": draws()}, indent=1))
