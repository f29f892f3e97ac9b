"""The faults that the cells of ``dtu-sgm`` can have, each planted in the
timed path through a test's ``monkeypatch``: an aggregation that hands back
its costs unscanned (the state unchanged), half of the views left out, and
the matcher's disparities moved by half a pixel where they are produced.
One card: no exchange between chips to leave out. Imports the program only
when a fault is planted."""

import numpy as np


def _state_unchanged(monkeypatch):
    from openmvs_tpu_torch.ops import sgm

    # every directional pass returns the costs it was given
    monkeypatch.setattr(sgm, "sgm_scan", lambda xs, p2s, p1, shift, diag: xs.clone())
    monkeypatch.setattr(sgm, "_sgm_scan_launch", lambda xs, p2s, p1, shift, diag: xs.clone())


def _half_left_out(monkeypatch):
    from openmvs_tpu_torch import densify

    views = densify._run_views_parallel
    monkeypatch.setattr(densify, "_run_views_parallel",
                        lambda fn, idx, devices: views(fn, list(idx)[::2], devices))


def _answer_altered(monkeypatch):
    from openmvs_tpu_torch.ops import sgm

    match = sgm.match_pair_tsgm

    def altered(*args, **kwargs):
        disp, cost = match(*args, **kwargs)
        return disp + np.float32(0.5), cost

    monkeypatch.setattr(sgm, "match_pair_tsgm", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}
