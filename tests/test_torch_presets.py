"""Port parity at the HDL-32 and HDL-64E ring geometries: the port's
LoamDriver against the JAX package's on the CPU, the sensor's real ring
table (``HDL32`` / ``HDL64E``: rings and vertical bounds) with reduced
capacities: 640 points a ring (600 azimuths simulated), test_torch_engine's
``slice_config()`` schedules and map, feature capacities from the ring
count (``Capacities.for_lidar``: at HDL-64E 768 sharp, 7,680 less-sharp,
1,536 flat, 16,384 less-flat, as at the full preset).

Tolerances and why: the sweeps are quantized to a 1/256 m grid, so
ingest and features are bit-equal and only the GN solves round
differently. Per-sweep odom / mapped / fused poses: 1e-4 (observed
maximum deviation: 3.0e-8 at HDL-32 and at HDL-64E); the mapping
flags and every telemetry counter: exact.
"""

import dataclasses

import numpy as np
import pytest

from loam_velodyne_tpu.config import HDL32, HDL64E
from loam_velodyne_tpu.io.driver import LoamDriver as JDriver
from loam_velodyne_torch.io.driver import LoamDriver as TDriver
from test_torch_engine import _port, _sweeps, slice_config

N = 4
N_AZIMUTH = 600
LIDARS = {"HDL-32": HDL32, "HDL-64E": HDL64E}


def preset_config(name: str):
    """slice_config() at the preset's ring geometry, 640 points a ring."""
    lidar = dataclasses.replace(LIDARS[name], max_points_per_ring=640)
    return dataclasses.replace(slice_config(), lidar=lidar, capacities=None)


@pytest.fixture(scope="module", params=list(LIDARS))
def runs(request):
    cfg = preset_config(request.param)
    xyz, mask, _ = _sweeps(cfg, N, n_azimuth=N_AZIMUTH)
    sweeps = [xyz[i][mask[i]] for i in range(N)]
    jd = JDriver(cfg, system_delay=0)
    td = TDriver(_port(cfg), device="cpu", system_delay=0)
    outs = [(jd.process_sweep(pts), td.process_sweep(pts)) for pts in sweeps]
    return request.param, cfg, jd, td, outs


def test_capacities_follow_the_ring_count(runs):
    name, cfg, _, td, _ = runs
    caps = td.cfg.capacities
    rows = cfg.lidar.n_rings * 6
    assert (caps.sharp, caps.flat) == (-(-rows * 2 // 128) * 128,
                                       -(-rows * 4 // 128) * 128)
    assert caps == _port(cfg).capacities
    assert td.sweep_capacity == cfg.lidar.n_rings * 640


def test_driver_matches_jax_at_the_ring_geometry(runs):
    name, cfg, jd, td, outs = runs
    for attr in ("trajectory", "odom_trajectory", "mapped_trajectory"):
        np.testing.assert_allclose(np.stack(getattr(td, attr)),
                                   np.stack(getattr(jd, attr)), rtol=0,
                                   atol=1e-4, err_msg=f"{name} {attr}")
    assert td.mapping_ran == [bool(o.mapping_ran) for o, _ in outs]
    assert any(td.mapping_ran)
    for j, t in outs:
        assert np.array_equal(np.asarray(j.packed)[20:], t.packed[20:])
    assert np.abs(np.stack(td.trajectory)[-1, 3:]).max() > 0.05   # it moved
