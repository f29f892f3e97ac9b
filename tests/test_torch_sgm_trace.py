"""SGM's spans and counters (``utils/log``): a recorded SGM densify on the
CPU gives the unrecorded one's cloud bit for bit; each view's ``sgm.view``
holds its pairs' ``sgm.pair`` (``sgm.rectify``, the matcher's
``sgm.level`` with ``sgm.inputs``, ``sgm.program``, ``sgm.download`` and
``sgm.check``, then ``sgm.project``) and its ``sgm.fuse``; ``sgm.pairs``,
``sgm.levels`` and ``sgm.volume_cells`` count what the spans show; and no
span opens inside a level's body, which on a card runs only at its
capture."""

import collections

import numpy as np
import torch

from openmvs_tpu_torch import densify
from openmvs_tpu_torch.config import DenseOptions
from openmvs_tpu_torch.ops import graphs, sgm
from openmvs_tpu_torch.synthetic import build_gt_scene
from openmvs_tpu_torch.utils import log
from openmvs_tpu_torch.view_selection import select_views_for_scene

torch.set_num_threads(2)

PARENT = {"sgm.view": "photometric pass", "sgm.pair": "sgm.view", "sgm.fuse": "sgm.view",
          "sgm.rectify": "sgm.pair", "sgm.level": "sgm.pair", "sgm.project": "sgm.pair",
          "sgm.inputs": "sgm.level", "sgm.program": "sgm.level",
          "sgm.download": "sgm.level", "sgm.check": "sgm.level"}


def _densify():
    scene, _, _ = build_gt_scene(n_views=3, W=96, H=72)
    return densify.dense_reconstruction(scene, DenseOptions(estimator="sgm"), device="cpu")


def test_recorded_sgm_densify_is_unchanged_and_nests_its_spans():
    plain = _densify()
    with log.recording() as rec:
        recorded = _densify()
    assert len(plain) > 0
    assert np.array_equal(np.asarray(plain.points), np.asarray(recorded.points))
    by_id = {sp.id: sp for sp in rec.spans}
    names = collections.Counter(sp.name for sp in rec.spans)
    assert names["sgm.view"] == 3 and names["sgm.fuse"] == 3
    assert names["sgm.pair"] == 6 and names["sgm.level"] == 12
    for sp in rec.spans:
        if sp.name in PARENT:
            assert by_id[sp.parent].name.startswith(PARENT[sp.name]), sp
    levels = [sp for sp in rec.spans if sp.name == "sgm.level"]
    assert sorted({sp.attrs["level"] for sp in levels}) == [0, 1]
    assert rec.counters["sgm.pairs"] == names["sgm.pair"]
    assert rec.counters["sgm.levels"] == len(levels)
    assert rec.counters["sgm.volume_cells"] == sum(
        2 * sp.attrs["hs"] * sp.attrs["ws"] * sp.attrs["num_d"] for sp in levels)
    assert "pm.sweeps" not in rec.counters


def test_no_span_inside_a_level_body(monkeypatch):
    inside = []
    body = sgm._level_body

    def watched(*args):
        n = len(log._active.spans)
        out = body(*args)
        inside.append(len(log._active.spans) - n)
        return out

    monkeypatch.setattr(sgm, "_level_body", watched)
    scene, _, _ = build_gt_scene(n_views=2, W=96, H=72)
    opts = DenseOptions(estimator="sgm")
    select_views_for_scene(scene, opts)
    with log.recording() as rec:
        densify.estimate_depth_map_sgm(scene, 0, opts, device="cpu", runners=graphs.Runners())
    assert len(inside) == 2 and set(inside) == {0}
    assert sum(sp.name == "sgm.program" for sp in rec.spans) == 2
