"""Multi-process offline map building: lanes sharded over processes.

Counterpart of ``loam_velodyne_tpu/parallel/multihost.py``, on
``torch.distributed``. Replay is pure data parallelism over independent
sequences (the engine step carries all cross-stage state), so a bag
archive replays as lanes sharded over processes:

- **One process per card.** The JAX module spans each host's devices
  with one mesh; here each process drives one CUDA card
  (``cuda:{rank % device_count}``), ``torchrun``-style, and replays its
  own lanes as one batched stream through
  ``parallel/replay.py::make_batched_chunk`` (the lane forms of K1-K4:
  one launch per kernel call for all local lanes). Several processes
  may share one card.
- **No collective in the hot loop.** Before it, one small
  ``all_gather`` of every process's (lanes, sweeps) so that all
  processes refuse the same bad input together; after it, **one**
  ``all_gather`` of the fused poses, (B_local, T, 6) float32, a few KB.
  Every process returns all lanes' positions, rank-major, as the JAX
  function's ``process_allgather`` does.
- **Gloo, not NCCL.** The gather moves host arrays, as the JAX
  package's ``process_allgather`` does, while the compute stays on the
  cards; NCCL refuses two ranks on one device, which is how two
  processes run on a one-card machine.
"""

from __future__ import annotations

import datetime
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay as replay_mod

# A dead peer fails a collective after this long, not after the
# default 30 minutes.
TIMEOUT = datetime.timedelta(minutes=5)


def init(coordinator: str, num_processes: int, process_id: int) -> None:
    """Join the process group: ``coordinator`` is ``host:port`` of rank
    0's rendezvous (any free port), over gloo."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def default_device() -> torch.device:
    """This process's card: ``cuda:{rank % device_count}``; without a
    card an error (``engine.require_device``)."""
    n = torch.cuda.device_count()
    return engine_mod.require_device(f"cuda:{dist.get_rank() % n}" if n
                                     else "cuda")


def _check_shapes(b_local: int, t_min: int, t_max: int, chunk: int) -> None:
    """Every process's lane count and sequence lengths, gathered, then
    refused on every process alike (so no process waits on a peer that
    left)."""
    mine = torch.tensor([b_local, t_min, t_max], dtype=torch.int64)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    shapes = torch.stack(rows).tolist()
    if any(b != shapes[0][0] for b, _, _ in shapes):
        raise ValueError(f"unequal lane counts over the processes: "
                         f"{[b for b, _, _ in shapes]}")
    if any(lo != hi or lo != shapes[0][1] for _, lo, hi in shapes):
        raise ValueError(f"unequal sequence lengths: (lanes, shortest, "
                         f"longest) by process {shapes}")
    t = shapes[0][1]
    if t == 0 or t % chunk:
        raise ValueError(f"sequence length {t} must be a positive multiple "
                         f"of chunk {chunk}")


def replay_global(cfg: LoamConfig, local_sequences: Sequence[Sequence[np.ndarray]],
                  chunk: int = 8, sweep_capacity: Optional[int] = None,
                  device=None, chunk_seconds: Optional[List[float]] = None
                  ) -> np.ndarray:
    """Multi-process batched replay: every process calls this with its
    OWN ``local_sequences`` (B_local lists of T per-sweep (N, 3) arrays,
    B_local and T equal over all processes, T a multiple of ``chunk``;
    points past ``sweep_capacity`` are cut); returns the ALL-GATHERED
    fused positions (B_global, T, 3) on every process, rank-major.

    ``device`` defaults to this process's card (``default_device``);
    the CPU runs only when asked for. With ``chunk_seconds`` each
    chunk's seconds (host clock, the device synchronized) are appended
    to it."""
    b_local = len(local_sequences)
    lengths = [len(s) for s in local_sequences] or [0]
    _check_shapes(b_local, min(lengths), max(lengths), chunk)
    device = (default_device() if device is None
              else engine_mod.require_device(device))
    cap = sweep_capacity or cfg.capacities.full_cloud
    t = lengths[0]

    step = replay_mod.make_batched_chunk(cfg)
    states = replay_mod.create_states(cfg, b_local, device)
    cadence = replay_mod.Cadence()
    poses = []
    for s in range(0, t, chunk):
        t0 = time.perf_counter()
        xyz = np.zeros((b_local, chunk, cap, 3), np.float32)
        mask = np.zeros((b_local, chunk, cap), bool)
        for i, seq in enumerate(local_sequences):
            for j, pts in enumerate(seq[s:s + chunk]):
                n = min(len(pts), cap)
                xyz[i, j, :n] = pts[:n]
                mask[i, j, :n] = True
        raw = RawSweep(torch.from_numpy(xyz).to(device),
                       torch.from_numpy(mask).to(device))
        states, outs = step(states, raw, cadence)
        for _ in range(chunk):
            cadence = cadence.advance(cfg)
        poses.append(outs.fused_pose)          # (B_local, chunk, 6)
        if chunk_seconds is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            chunk_seconds.append(time.perf_counter() - t0)

    # The one gather of the run: every process receives every lane.
    local = torch.cat(poses, 1).to("cpu", torch.float32).contiguous()
    rows = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, local)
    return torch.cat(rows).numpy()[:, :, 3:]
