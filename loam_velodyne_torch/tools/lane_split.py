"""Where the batched replay and the single stream part, on one card.

Two readings on the VLP-16 bench sequence at datasheet capacities:

1. The batched chunk (``parallel/replay.py::make_batched_chunk``) at
   B = 1 against the single stream's ``run_chunk`` over ``--sweeps``
   sweeps in chunks of 8: the largest pose deviation by sweep. At
   B = 1 the lane forms are the single-lane kernels, so what is left is
   what the batching rules of the other operations change.
2. From a common state (the single stream's after ``--before`` sweeps),
   the next sweep stepped by the single stream and by the batched step
   op by op (``make_eager_batched_step``: each lane's decisions taken on
   the device, as the graphed ``make_batched_step`` takes them) at
   B = 1 and at B = ``--lanes`` identical lanes. The B-lane step records every call of the functions of
   ``device_split.TRACED`` (lane 0 of each batched argument and
   output), and so does the single stream's step. Each batched call is
   then replayed single-lane on the card with its own lane-0 inputs: a
   call whose replay differs is where a split is born (given the same
   inputs, the batched form computes otherwise; a call is listed before
   the calls it makes, so the innermost of a nest is the place);
   ``paired`` holds each batched call against the single stream's call
   of the same index, which shows how far a split has travelled.

Floats are compared by their largest absolute difference, integers and
booleans by the number of elements that differ
(``device_split.deviation``).

    python3 -m loam_velodyne_torch.tools.lane_split [--before 3] [--lanes 8]

Writes a JSON report (by default ``build/lane_split/split_<before>.json``
at the repository root) and prints a summary. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch._C import _functorch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay
from loam_velodyne_torch.tools import device_split

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SWEEP_CAP = 32768
CHUNK = 8


def _lane0(x):
    """Lane 0 of a tree of (possibly vmapped) tensors, copied to the
    host; an unbatched tensor is the same for every lane."""
    if isinstance(x, torch.Tensor):
        if _functorch.is_batchedtensor(x):
            bdim = _functorch.maybe_get_bdim(x)
            x = _functorch.get_unwrapped(x).select(bdim, 0)
        return x.detach().to("cpu", copy=True)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_lane0(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_lane0(v) for v in x)
    if isinstance(x, dict):
        return {k: _lane0(v) for k, v in x.items()}
    return x


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _clone(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(x) for x in tree))
    return tree.clone()


def _pose_rows(packed: torch.Tensor) -> np.ndarray:
    """The 18 pose columns (odometry, mapped, fused) of packed outputs."""
    return packed[..., :18].double().cpu().numpy()


def chunk_at_one_lane(cfg, dev, xyz, mask) -> dict:
    """Reading 1: the single stream and the batched chunk at B = 1."""
    single = engine_mod.Engine(cfg, dev)
    chunk = replay.make_batched_chunk(cfg)
    states = replay.create_states(cfg, 1, dev)
    cadence = engine_mod.Cadence()
    rows_1, rows_b = [], []
    for s in range(0, xyz.shape[0], CHUNK):
        rows_1.append(_pose_rows(single.run_chunk(xyz[s:s + CHUNK],
                                                  mask[s:s + CHUNK]).packed))
        states, outs = chunk(states, RawSweep(xyz[None, s:s + CHUNK],
                                              mask[None, s:s + CHUNK]), cadence)
        for _ in range(CHUNK):
            cadence = cadence.advance(cfg)
        rows_b.append(_pose_rows(outs.packed[0]))
    dev_by_sweep = np.abs(np.concatenate(rows_b) - np.concatenate(rows_1)).max(1)
    return {"max_dev_by_sweep": dev_by_sweep.tolist(),
            "first_sweep_apart": (int(np.flatnonzero(dev_by_sweep)[0])
                                  if dev_by_sweep.any() else None)}


def split_sweep(cfg, dev, xyz, mask, before: int, lanes: int) -> dict:
    """Reading 2: the sweep after ``before`` from the single stream's
    state, single-lane and batched, with the traced calls."""
    state, cadence = engine_mod.EngineState.create(cfg, dev), engine_mod.Cadence()

    def mode(c):
        return "on" if c.gate(cfg)[1] else "off"

    for i in range(before):
        state, _ = engine_mod.step(state, RawSweep(xyz[i], mask[i]), cfg,
                                   mode(cadence), cadence, None,
                                   static_schedule=True)
        cadence = cadence.advance(cfg)
    raw = RawSweep(xyz[before], mask[before])

    rec_single = device_split.Recorder()
    rec_lanes = device_split.Recorder(host=_lane0)
    rec_single.install()
    try:
        _, one = engine_mod.step(_clone(state), raw, cfg, mode(cadence), cadence,
                                 None, static_schedule=True)
        single_calls = rec_single.run(lambda: engine_mod.step(
            _clone(state), raw, cfg, mode(cadence), cadence, None,
            static_schedule=True))
    finally:
        rec_single.remove()
    step = replay.make_eager_batched_step(cfg)
    result = {}
    for b in sorted({1, lanes}):
        states = replay.stack_states([_clone(state) for _ in range(b)])
        raws = RawSweep(xyz[before][None].expand(b, -1, -1).contiguous(),
                        mask[before][None].expand(b, -1).contiguous())
        if b == lanes:
            rec_lanes.install()
            try:
                calls = rec_lanes.run(lambda: step(states, raws))
            finally:
                rec_lanes.remove()
        _, outs = step(states, raws)
        got = _pose_rows(outs.packed)
        result[f"pose_dev_b{b}"] = float(np.abs(got - _pose_rows(one.packed)).max())
        result[f"lanes_equal_b{b}"] = bool((got == got[0]).all())

    trace = []
    for i, (label, fn, a, kw, got) in enumerate(calls):
        want = device_split._host(fn(*_to(a, dev), **_to(kw, dev)))
        entry = {"i": i, "call": label,
                 "replay": device_split.deviation(got, want)}
        if i < len(single_calls) and single_calls[i][0] == label:
            entry["paired"] = device_split.deviation(got, single_calls[i][4])
        trace.append(entry)
    # A call is listed before the calls it makes: the innermost of a
    # nest of listed calls is where the split is born.
    apart = [[e["i"], e["call"], e["replay"]["float"], e["replay"]["int"]]
             for e in trace if e["replay"]["float"] or e["replay"]["int"]]
    result.update(calls=len(calls), single_calls=len(single_calls),
                  same_call_sequence=[c[0] for c in calls]
                  == [c[0] for c in single_calls],
                  replay_apart=apart, trace=trace)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--before", type=int, default=3,
                   help="sweeps stepped before the split sweep")
    p.add_argument("--sweeps", type=int, default=16,
                   help="sweeps of the B = 1 chunk run (a multiple of 8)")
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", help="the JSON report (default: "
                                 "build/lane_split/split_<before>.json)")
    args = p.parse_args(argv)
    dev = engine_mod.require_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LoamConfig.preset("VLP-16")
    n = max(args.sweeps, args.before + 1)
    xyz, mask, _ = synthetic.bench_sequence(n, cfg.lidar, SWEEP_CAP)
    xyz, mask = torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)

    t0 = time.perf_counter()
    report = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu"), "before": args.before, "lanes": args.lanes}
    report["chunk_b1"] = chunk_at_one_lane(cfg, dev, xyz[:args.sweeps],
                                           mask[:args.sweeps])
    report["split"] = split_sweep(cfg, dev, xyz, mask, args.before, args.lanes)
    report["seconds"] = time.perf_counter() - t0
    out = args.out or os.path.join(ROOT, "build", "lane_split",
                                   f"split_{args.before}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)

    c1, sp = report["chunk_b1"], report["split"]
    print(f"B = 1 chunk against the single stream, {args.sweeps} sweeps: "
          f"largest pose deviation by sweep "
          f"{[float(f'{d:.3g}') for d in c1['max_dev_by_sweep']]}")
    print(f"sweep {args.before} from the single stream's state: pose deviation "
          f"B = 1 {sp['pose_dev_b1']:.3g}, B = {args.lanes} "
          f"{sp[f'pose_dev_b{args.lanes}']:.3g} (lanes equal: "
          f"{sp[f'lanes_equal_b{args.lanes}']}); {sp['calls']} traced calls "
          f"(single stream {sp['single_calls']}, same sequence "
          f"{sp['same_call_sequence']})")
    for e in sp["trace"]:
        r, q = e["replay"], e.get("paired", {"float": float("nan"), "int": -1})
        line = (f"{e['i']:4d} {e['call']:38s} replay {r['float']:.3g}/{r['int']}"
                f" paired {q['float']:.3g}/{q['int']}")
        if r["float"] or r["int"]:
            line += " replay leaves " + json.dumps(
                [v if isinstance(v, int) else [float(f"{x:.3g}") for x in v]
                 for v in r["leaves"]])
        print(line)
    print(json.dumps({"replay_apart": sp["replay_apart"],
                      **{k: v for k, v in sp.items()
                         if k.startswith(("pose_dev", "lanes_equal"))},
                      "chunk_b1_first_sweep_apart": c1["first_sweep_apart"],
                      "seconds": report["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
