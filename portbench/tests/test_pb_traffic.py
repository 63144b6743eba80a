"""The generators: the same seed gives the same traffic, another seed
other traffic of the same amount."""

import numpy as np
import pytest

from portbench.tests import tiny
from portbench.traffic import qa


def make(name, seed):
    c = tiny.cell(name)
    return qa.make(c.traffic, c.config, seed, "cpu")


@pytest.mark.parametrize("name", ["vqa_cl_train", "nextqa_cl_train"])
def test_same_seed_same_traffic(name):
    a, b = make(name, 2 ** 31 + 5), make(name, 2 ** 31 + 5)
    assert a.items == b.items
    assert np.array_equal(a.table.feats, b.table.feats)
    assert np.array_equal(a.table.boxes, b.table.boxes)
    assert a.cate_map == b.cate_map and a.ques_map == b.ques_map


@pytest.mark.parametrize("name", ["vqa_cl_train", "nextqa_cl_train"])
def test_other_seed_other_traffic(name):
    a, b = make(name, 1), make(name, 2)
    assert not np.array_equal(a.table.feats, b.table.feats)
    assert [d["img_id"] for t in a.items.values() for s in t.values()
            for d in s] != [d["img_id"] for t in b.items.values()
                            for s in t.values() for d in s]
    # the same amount of work: counts per split do not depend on the seed
    assert {t: {s: len(v) for s, v in x.items()} for t, x in a.items.items()} \
        == {t: {s: len(v) for s, v in x.items()} for t, x in b.items.items()}


def test_features_cluster_by_category():
    t = make("vqa_cl_train", 3)
    cats = np.array([t.cate_map[i] for i in t.table.ids])
    c = cats[0]
    same = t.table.feats[cats == c].mean((0, 1))
    other = t.table.feats[cats != c].mean((0, 1))
    row = t.table.feats[0].mean(0)
    assert np.linalg.norm(row - same) < np.linalg.norm(row - other)


def test_boxes_in_unit_square():
    t = make("vqa_cl_train", 4)
    assert t.table.boxes.min() >= 0.0 and t.table.boxes.max() <= 1.0
    n = make("nextqa_cl_train", 4)
    assert np.all(n.table.boxes == np.array([0, 0, 1, 1], np.float32))

