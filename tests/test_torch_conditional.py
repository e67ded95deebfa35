"""The GN's early exit (``models/conditional.py``) on the CPU: what the
conditional nodes of the graphed chunk and per-sweep step rest on.

On the card, a captured GN phase, and each iteration after a phase's
first, is an IF node that the card skips once the GN has stopped (on
every lane, in the batched chunk). Here ``host_conditionals`` stands in
for the node: the region's Python runs as it does while a graph is
captured, and when its predicate (read on the host, out of sight of
any recorder) is false, what a skipped node leaves behind is emulated:
every write to a tensor born outside the region is dropped, and the
memory of every tensor born inside it that something still holds is
poisoned afterwards (all bits set: NaN, -1, true), as memory that a
skipped node never wrote holds whatever it held. At
the port's ``tiny_config()`` with GNs of several phases:

- skipping gives bit for bit the packed rows and state of running
  every phase masked (the eager forms), for the static chunk single
  lane and batched (two lanes that stop in different phases, a lane
  whose GN never starts, abort thresholds at 0 so every phase runs,
  clouds too small so no GN starts), with and without IMU windows;
- the correspondence (K3) and k-NN (K4) searches that run (none in a
  skipped region) are the eager dynamic step's on a single lane, and in
  the batched one those whose regions' predicates all held in the eager
  batched run (the predicates ``launches.needed`` makes the eager regions
  give ``launches.within``);
- the predicate: ``~done`` on one lane, any lane's under vmap, an
  unbatched flag;
- a region whose output is born inside it (a mutated
  ``run_if_running``) is caught: the stand-in's rows differ.

The per-sweep composition through the stand-in is
tests/test_torch_step_graph.py's. Tolerance: none.
"""

import contextlib
import dataclasses
import weakref

import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from test_torch_graph import HostReads

from loam_velodyne_torch.io import synthetic
from loam_velodyne_torch.io.imu import ImuTracker
from loam_velodyne_torch.models import conditional
from loam_velodyne_torch.models import engine as engine_mod
from loam_velodyne_torch.models import graph as graph_mod
from loam_velodyne_torch.ops import launches, neighbors
from loam_velodyne_torch.ops.imu import ImuWindow
from loam_velodyne_torch.ops.scan import RawSweep
from loam_velodyne_torch.parallel import replay

# One intra-op thread: the tier-1 run has six workers on eight cores,
# and torch's default of a thread a core oversubscribes them.
torch.set_num_threads(1)

K = 4
CAP = 256


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


_WRITES: dict = {}


def _written(func, args, kwargs) -> list:
    """The tensors an operation writes (its schema's mutable arguments)."""
    spec = _WRITES.get(func)
    if spec is None:
        spec = _WRITES[func] = [
            (i, arg.name) for i, arg in enumerate(func._schema.arguments)
            if arg.alias_info is not None and arg.alias_info.is_write]
    out = []
    for i, name in spec:
        v = kwargs[name] if name in kwargs else (
            args[i] if i < len(args) else None)
        out += _tensors(v)
    return out


class SkippedRegion(TorchDispatchMode):
    """The operations of a region that a replay skips: a write to a
    tensor born outside it is dropped, and ``poison`` then spoils the
    memory of every tensor born inside it that is still alive."""

    def __init__(self):
        super().__init__()
        self.born = {}                   # storage -> weak refs to tensors

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        written = _written(func, args, kwargs)
        if any(_storage(t) and _storage(t) not in self.born for t in written):
            if not func._schema.returns:
                return None
            return written[0] if len(func._schema.returns) == 1 else tuple(written)
        out = func(*args, **kwargs)
        if not written:
            inputs = {_storage(t) for t in _tensors(list(args))
                      + _tensors(list(kwargs.values()))}
            for t in _tensors(out):
                ptr = _storage(t)
                if ptr and (ptr in self.born or ptr not in inputs):
                    self.born.setdefault(ptr, []).append(weakref.ref(t))
        return out

    def poison(self) -> None:
        """All bits set in what the region made and something still
        holds: NaN as a float, -1 as an integer, true as a bool."""
        for refs in self.born.values():
            alive = next((t for t in (r() for r in refs) if t is not None),
                         None)
            if alive is not None:
                alive.untyped_storage().fill_(0xFF)


_UNCOUNTED = [0]   # blocks open whose searches the card would not run
_AROUND: list = []  # the predicates of the eager regions around


@contextlib.contextmanager
def uncounted():
    """Searches inside the block are not counted (``_Searches``)."""
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


def host_node(pred, region, poison: bool = True):
    """The stand-in for a captured IF node (see the module docstring).
    ``poison`` False skips a region without running its Python: the same
    result for a region that leaves nothing born inside it behind, and
    faster."""
    with _disable_current_modes():
        run = bool(pred)
    if run:
        region()
    elif poison:
        mode = SkippedRegion()
        with uncounted(), mode:
            region()
        mode.poison()


@contextlib.contextmanager
def host_conditionals(poison: bool = True):
    """Inside the block every conditional region goes through
    ``host_node``, as if a graph were being captured."""
    saved = conditional.capturing, conditional.node
    conditional.capturing = lambda t: True
    conditional.node = lambda pred, region: host_node(pred, region, poison)
    try:
        yield
    finally:
        conditional.capturing, conditional.node = saved


@contextlib.contextmanager
def _within(pred):
    _AROUND.append(pred)
    try:
        yield
    finally:
        _AROUND.pop()


@contextlib.contextmanager
def needed_searches(monkeypatch):
    """Inside the block the eager regions give their predicates to
    ``launches.within`` as in a ``launches.needed`` block (the CPU
    counts no launch): ``_Searches`` counts a search only where every
    region around it would run on the card."""
    with monkeypatch.context() as m:
        m.setattr(launches, "tallying", lambda: True)
        m.setattr(launches, "within", _within)
        yield


def _cfg(case: str = "stops", odo_every: int = 5, map_every: int = 2):
    """tiny_config() with GNs of several phases: odometry 12 iterations
    refreshed every ``odo_every`` (5 + 5 + 2 by default), mapping 5
    refreshed every ``map_every`` (2 + 2 + 1)."""
    cfg = replay.tiny_config()
    odo = dataclasses.replace(cfg.odometry, max_iterations=12,
                              corresp_refresh_every=odo_every,
                              min_corner_points=2)
    m = dataclasses.replace(cfg.mapping, max_iterations=5,
                            corresp_refresh_every=map_every,
                            min_corner_map_points=2)
    if case == "all_phases":
        odo = dataclasses.replace(odo, delta_r_abort=0.0, delta_t_abort=0.0)
        m = dataclasses.replace(m, delta_r_abort=0.0, delta_t_abort=0.0)
    elif case == "too_small":
        odo = dataclasses.replace(odo, min_corner_points=10 ** 6)
        m = dataclasses.replace(m, min_corner_map_points=10 ** 6)
    return dataclasses.replace(cfg, odometry=odo, mapping=m)


def _sweeps(cfg, seed=3, speed=1.0):
    sweeps, _ = synthetic.noisy_turning(K, cfg.lidar, seed=seed, speed=speed)
    xyz, mask = synthetic.pad_sweeps(sweeps, CAP)
    return torch.from_numpy(xyz), torch.from_numpy(mask)


def _windows():
    tracker = ImuTracker()
    for t, rpy, acc in synthetic.imu_stream(K):
        tracker.push_state(t, rpy, acc)
    rows = [tracker.window_for_sweep(0.1 * k, device="cpu") for k in range(K)]
    return ImuWindow(*(torch.stack(a) for a in zip(*rows)))


def _leaves_equal(a, b) -> bool:
    la, lb = graph_mod.leaves(a), graph_mod.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


class _Searches:
    """Counts the correspondence (K3) and k-NN (K4) searches that the
    card would run: none in a skipped region (``uncounted``), and under
    ``needed_searches`` only those whose regions' predicates all hold."""

    def __init__(self, monkeypatch):
        self.n = {"corresp": 0, "knn": 0}
        for name, fn in (("corresp", neighbors.corresp_search),
                         ("knn", neighbors.grouped_window_knn)):
            monkeypatch.setattr(neighbors, fn.__name__, self._counted(name, fn))

    def _counted(self, name, fn):
        def counted(*args, **kwargs):
            if not _UNCOUNTED[0] and all(bool(p) for p in _AROUND):
                self.n[name] += 1
            return fn(*args, **kwargs)
        return counted

    def take(self) -> dict:
        n, self.n = self.n, {"corresp": 0, "knn": 0}
        return n


def _single(cfg, xyz, mask, wins, static=True):
    return engine_mod.run_chunk(engine_mod.EngineState.create(cfg, "cpu"),
                                RawSweep(xyz, mask), cfg, imu_windows=wins,
                                static_cadence=static)


SINGLE = [("stops", False), ("stops", True), ("all_phases", False),
          ("too_small", False)]


@pytest.mark.parametrize("case,imu", SINGLE,
                         ids=[f"{c}-{'imu' if i else 'no_imu'}" for c, i in SINGLE])
def test_skipping_equals_the_masked_static_chunk(monkeypatch, case, imu):
    """The static chunk from a fresh state (the first group and a steady
    one): with the stand-in, bit for bit the eager chunk, no host read
    besides the stand-in's, and the searches of the eager dynamic step
    (two a GN refresh: corner and surf)."""
    cfg = _cfg(case)
    xyz, mask = _sweeps(cfg)
    wins = _windows() if imu else None
    want_state, want = _single(cfg, xyz, mask, wins)
    searches = _Searches(monkeypatch)
    dyn_state, dyn = _single(cfg, xyz, mask, wins, static=False)
    searched = searches.take()
    assert torch.equal(dyn.packed, want.packed)
    with HostReads() as reads, host_conditionals():
        state, got = _single(cfg, xyz, mask, wins)
    ran = searches.take()
    assert reads.hits == []
    assert torch.equal(got.packed, want.packed)
    assert _leaves_equal(state, want_state)
    assert ran == searched
    odo_phases, map_phases = 3, 3
    if case == "all_phases":
        # Every odometry GN runs all its phases; the first mapping frame
        # has no map to align to, so its GN never starts.
        assert ran == {"corresp": 2 * odo_phases * (K - 1),
                       "knn": 2 * map_phases * (K // 2 - 1)}
    elif case == "too_small":
        assert ran == {"corresp": 0, "knn": 0}
    else:
        assert 0 < ran["corresp"] < 2 * odo_phases * (K - 1)
    # Mapping ran on the odd sweeps: the static chunk was exercised.
    assert got.packed[:, 18].tolist() == [float(i % 2) for i in range(K)]


def _lanes(cfg, kind: str):
    """Two lanes: 1 and 8 m/s, whose odometry GNs stop in different
    phases, or the second with too few points for any GN to start
    (``starved``)."""
    (x0, m0), (x1, m1) = _sweeps(cfg, 3, 1.0), _sweeps(cfg, 5, 8.0)
    if kind == "starved":
        m1 = m1 & (torch.arange(CAP) < 12)
    return torch.stack([x0, x1]), torch.stack([m0, m1])


def _batched(cfg, xyz, mask, wins):
    bwins = (None if wins is None
             else ImuWindow(*(torch.stack([w] * 2) for w in wins)))
    chunk = replay.make_eager_batched_chunk(cfg, with_imu=wins is not None)
    return chunk(replay.create_states(cfg, 2, "cpu"), RawSweep(xyz, mask),
                 imu_windows=bwins)


BATCHED = [("stops", "distinct", False), ("stops", "distinct", True),
           ("stops", "starved", False), ("all_phases", "distinct", False)]


@pytest.mark.parametrize("case,lanes,imu", BATCHED, ids=[
    f"{c}-{n}-{'imu' if i else 'no_imu'}" for c, n, i in BATCHED])
def test_skipping_equals_the_masked_batched_chunk(monkeypatch, case, lanes,
                                                  imu):
    """Two lanes under vmap: a region runs while either lane runs, and a
    lane that has stopped is untouched by it. With the stand-in, bit for
    bit the eager batched chunk, and the searches run are those whose
    regions' predicates held in the eager run. Odometry refreshes every
    2 iterations (6 phases), mapping every one (5)."""
    cfg = _cfg(case, odo_every=2, map_every=1)
    xyz, mask = _lanes(cfg, lanes)
    wins = _windows() if imu else None
    searches = _Searches(monkeypatch)
    with needed_searches(monkeypatch):
        want_states, want = _batched(cfg, xyz, mask, wins)
    needed = searches.take()
    with host_conditionals():
        states, got = _batched(cfg, xyz, mask, wins)
    ran = searches.take()
    assert torch.equal(got.packed, want.packed)
    assert _leaves_equal(states, want_states)
    assert ran == needed
    # Each lane alone: the lanes stop apart (or one never starts), so
    # the pair runs at least as many searches as either lane.
    alone = []
    for i in range(2):
        with needed_searches(monkeypatch):
            _single(cfg, xyz[i], mask[i], wins)
        alone.append(searches.take())
    for kind in ("corresp", "knn"):
        assert ran[kind] >= max(a[kind] for a in alone)
    if lanes == "starved":
        assert alone[1] == {"corresp": 0, "knn": 0}
        assert ran == alone[0]
    elif case == "stops":
        assert alone[0] != alone[1]


def test_the_predicate_is_any_lane_running():
    done = torch.tensor([True, False, True])
    assert not conditional.running(torch.tensor(True))
    assert conditional.running(torch.tensor(False))
    seen = []

    def lane(d):
        p = conditional.running(d)
        seen.append(p)
        return d.clone()

    torch.func.vmap(lane)(done)
    torch.func.vmap(lane)(torch.ones(3, dtype=torch.bool))
    assert [p.shape for p in seen] == [torch.Size([])] * 2
    assert seen[0].item() is True and seen[1].item() is False


def test_a_region_output_born_inside_it_is_caught(monkeypatch):
    """A mutated ``run_if_running`` that returns what the body made
    inside the region instead of copying it into outputs made before:
    where a region is skipped, that output holds nothing, and the
    stand-in's rows differ from the eager chunk's."""
    cfg = _cfg()
    xyz, mask = _sweeps(cfg)
    _, want = _single(cfg, xyz, mask, None)

    def born_inside(done, body, carry):
        if not conditional.capturing(done):
            return body(carry)
        out = []
        conditional.node(conditional.running(done),
                         lambda: out.append(body(carry)))
        return out[0]

    monkeypatch.setattr(conditional, "run_if_running", born_inside)
    with host_conditionals():
        _, got = _single(cfg, xyz, mask, None)
    assert not torch.equal(got.packed, want.packed)
    assert not torch.isfinite(got.packed).all()


def test_eager_regions_run_their_body():
    """Off a capture a region is its body, whatever ``done`` says, and a
    node is captured only inside ``graph.capture``."""
    calls = []

    def body(c):
        calls.append(c)
        return (c[0] + 1,)

    assert conditional.run_if_running(torch.tensor(True), body,
                                      (torch.tensor(1.0),))[0].item() == 2.0
    assert len(calls) == 1
    with pytest.raises(RuntimeError, match="only inside"):
        conditional.node(torch.tensor(True), lambda: None)


def test_launch_counts_eager_graphed_and_needed(monkeypatch):
    """``ops/launches.py`` on the CPU's tensors: an eager launch adds to
    the wrapper's ``launches``, and so does one captured outside
    ``on_card``; one captured inside it adds to its counter on the
    device, which ``settle`` adds to ``launches`` and sets to 0; inside
    ``needed`` an eager launch is tallied where every region around it
    would run."""
    def wrapper():
        pass

    wrapper.launches = 0
    dev = torch.device("cpu")
    launches.count(wrapper, dev)
    assert wrapper.launches == 1
    with launches.needed() as needed:
        launches.count(wrapper, dev)
        with launches.within(torch.tensor(True)):
            launches.count(wrapper, dev)
            with launches.within(torch.tensor(False)):
                launches.count(wrapper, dev)
    assert needed() == {"wrapper": 2} and wrapper.launches == 4
    assert not launches.tallying()
    with monkeypatch.context() as m:
        m.setattr(launches, "_capturing", lambda device: True)
        launches.count(wrapper, dev)    # a capture that times a kernel
    assert wrapper.launches == 5
    with launches.on_card(dev, [wrapper]), monkeypatch.context() as m:
        m.setattr(launches, "_capturing", lambda device: True)
        for _ in range(3):
            launches.count(wrapper, dev)
    assert wrapper.launches == 5
    assert launches.settle()["wrapper"] == 3 and wrapper.launches == 8
    assert launches.settle()["wrapper"] == 0 and wrapper.launches == 8
    launches._on_card.pop((dev, wrapper))
