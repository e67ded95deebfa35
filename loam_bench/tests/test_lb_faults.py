"""The check sees the faults a cell can have: each run here skips the
look for a card and drives a tiny cell on the CPU with the timed path
broken underneath, and ``correct`` must come out false; the same runs
unbroken come out true.

Faults: a step that returns its state unchanged; half of the batch left
out, its outputs the mean of the other half's; an answer (a fused
position, by 0.5 m, five times the distance a sweep moves) altered where
it is produced. The live entry has one lane, so no half batch; no cell
spans chips, so no exchange between them. The small cell (``tiny.py``)
samples the start of every lane the batched chunk drives (both of its
two lanes), so a fault in either half shows.
"""

import time

import pytest
import torch

from loam_bench import run
from loam_bench.tests import tiny
from loam_velodyne_torch.io.driver import LoamDriver
from loam_velodyne_torch.parallel import replay

torch.set_num_threads(1)
SEED = 2 ** 31 + 97
ALTER_M = 0.5
WINDOW_S = {"batched_chunk": 1.0, "live": 10.0}


def _lanes(tree, sl):
    if isinstance(tree, torch.Tensor):
        return tree[sl]
    return type(tree)(*(_lanes(x, sl) for x in tree))


def _cat(a, b):
    if isinstance(a, torch.Tensor):
        return torch.cat([a, b])
    return type(a)(*(_cat(x, y) for x, y in zip(a, b)))


def broken(make, fault):
    """``make``'s batched callable with ``fault`` planted in it."""
    def factory(cfg, *a, **k):
        real = make(cfg, *a, **k)

        def fn(states, raw, *args):
            if fault == "half":
                h = raw.xyz.shape[0] // 2
                kept = raw._replace(xyz=raw.xyz[:h], mask=raw.mask[:h])
                s1, o1 = real(_lanes(states, slice(0, h)), kept, *args)
                mean = o1.packed.mean(0, keepdim=True).expand_as(o1.packed)
                return (_cat(s1, _lanes(states, slice(h, None))),
                        o1._replace(packed=torch.cat([o1.packed, mean])))
            new, outs = real(states, raw, *args)
            if fault == "unchanged":
                return states, outs
            p = outs.packed.clone()
            p[..., 15] += ALTER_M
            return new, outs._replace(packed=p)
        return fn
    return factory


REAL_PROCESS_SWEEP = LoamDriver.process_sweep


def unchanged_sweep(self, pts, stamp=None):
    state, cadence = self.engine.state, self.engine.cadence
    out = REAL_PROCESS_SWEEP(self, pts, stamp)
    if out is not None:
        self.engine.state, self.engine.cadence = state, cadence
    return out


def altered_sweep(self, pts, stamp=None):
    out = REAL_PROCESS_SWEEP(self, pts, stamp)
    if out is None:
        return out
    p = out.packed.copy()
    p[15] += ALTER_M
    return out._replace(packed=p)


def _run(tmp_path, entry):
    cell = tiny.plan(str(tmp_path), entry)
    if entry != "live":
        cell.check["sample"]["starts"] = cell.traffic["lanes"]
    return run.run_cell(cell, SEED, WINDOW_S[entry], False, "cpu",
                        time.time())["result"]


@pytest.mark.parametrize("entry", ["batched_chunk", "live"])
def test_sound_runs_are_correct(tmp_path, entry):
    r = _run(tmp_path, entry)
    assert r["correct"] and r["failed"] == 0, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("entry, factory", [
    ("batched_chunk", "make_batched_chunk")])
def test_batched_faults_are_caught(tmp_path, monkeypatch, entry, factory,
                                   fault):
    monkeypatch.setattr(replay, factory,
                        broken(getattr(replay, factory), fault))
    r = _run(tmp_path, entry)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


@pytest.mark.parametrize("fault", [unchanged_sweep, altered_sweep])
def test_live_faults_are_caught(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(LoamDriver, "process_sweep", fault)
    r = _run(tmp_path, "live")
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
