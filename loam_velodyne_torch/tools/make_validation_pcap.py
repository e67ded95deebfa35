"""Generate a spec-exact Velodyne VLP-16 wire-format capture for the
real-data `validate` gate.

The port's copy of the repository's ``tools/make_validation_pcap.py``
(which imports the JAX package), plus ``write_validation_pcap``. Where
the reference's MD5-pinned test bag (cli.REFERENCE_TEST_DATA_URL,
reference CMakeLists.txt:55-57) cannot be fetched, it runs the packet
layout of io/pcap.py in REVERSE over the raycast simulator so the full
wire path (pcap framing -> native C++ decode -> azimuth
rollover sweep split -> ring binning -> pipeline) runs against
datasheet-faithful packets:

- 1206-byte payloads: 12 blocks x [0xEEFF, azimuth/100deg,
  32 x (range*2mm, reflectivity)], product id 0x22, single-return
  (factory byte 0x37)
- real firing order (the interleaved VLP16_ELEVATIONS_DEG laser table,
  NOT ring order), two firings per block with the decoder's
  half-azimuth interpolation accounted for exactly
- real azimuth density (0.2 deg/firing = 1800 firings/rev at 10 Hz)
- range noise (sigma = 5 mm), 2% random dropouts, motion distortion
  from a continuously moving, turning trajectory

Output: .validation_data/corridor_vlp16.pcap (+ ground-truth positions
alongside, for reporting). Deterministic (fixed seeds) so the recorded
golden trace stays valid.

    python3 -m loam_velodyne_torch.tools.make_validation_pcap [n_sweeps] [out.pcap]
"""

import os
import sys

import numpy as np

from loam_velodyne_torch.config import VLP16
from loam_velodyne_torch.io import pcap as pcap_io
from loam_velodyne_torch.io import synthetic

N_AZ = 1800                      # 0.2 deg per firing (VLP-16 @ 10 Hz)
DROPOUT = 0.02
NOISE_STD = 0.005


def range_image(rects, traj, t0, n_az=N_AZ, scan_period=0.1,
                noise_std=NOISE_STD, dropout=DROPOUT, seed=0):
    """(A, 16) first-hit ranges in RING order (low ring first) + block
    azimuths in degrees. Same geometry as synthetic.raycast_sweep (the
    sensor moves during the revolution -> motion distortion is encoded
    in the ranges), plus dropouts."""
    lidar = VLP16
    elev = np.deg2rad(np.linspace(lidar.lower_bound_deg,
                                  lidar.upper_bound_deg, lidar.n_rings))
    az = 2 * np.pi * np.arange(n_az) / n_az
    times = t0 + scan_period * np.arange(n_az) / n_az
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    dirs_sensor = np.stack([
        np.outer(ca, ce), np.outer(-sa, ce),
        np.broadcast_to(se, (n_az, lidar.n_rings)),
    ], axis=-1)
    pos = np.stack([traj(t)[0] for t in times])
    yaw = np.array([traj(t)[1] for t in times])
    cy, sy = np.cos(yaw), np.sin(yaw)
    dx = dirs_sensor[..., 0] * cy[:, None] - dirs_sensor[..., 1] * sy[:, None]
    dy = dirs_sensor[..., 0] * sy[:, None] + dirs_sensor[..., 1] * cy[:, None]
    dz = dirs_sensor[..., 2]
    dirs_world = np.stack([dx, dy, dz], axis=-1).reshape(-1, 3)
    origins = np.repeat(pos, lidar.n_rings, axis=0)
    dist = synthetic._raycast(origins, dirs_world, rects)
    rng = np.random.default_rng(seed)
    dist = dist + rng.normal(0.0, noise_std, dist.shape)
    dist[rng.uniform(size=dist.shape) < dropout] = np.inf   # dropouts
    img = dist.reshape(n_az, lidar.n_rings)
    img = np.where(np.isfinite(img), img, 0.0)              # 0 = no return
    return img, np.degrees(az)


def packets_for_sweep(img: np.ndarray, az_deg: np.ndarray):
    """Range image (RING order) -> spec VLP-16 payloads: channels in the
    sensor's interleaved LASER order; two firings per block (consecutive
    azimuth columns — matching the decoder's half-azimuth interpolation
    az0 + (az_next_block - az0)/2 exactly)."""
    n_az = img.shape[0]
    assert n_az % 24 == 0, "azimuth count must fill whole packets"
    # laser channel ch fires at elevation VLP16_ELEVATIONS_DEG[ch];
    # its ring index is that elevation's rank in ascending order.
    ring_of_ch = np.argsort(np.argsort(pcap_io.VLP16_ELEVATIONS_DEG))
    pkts = []
    for p in range(n_az // 24):
        col0 = 24 * p
        azs = [float(az_deg[col0 + 2 * b]) for b in range(12)]
        ranges = np.zeros((12, 32))
        for b in range(12):
            for firing in range(2):
                col = col0 + 2 * b + firing
                ranges[b, 16 * firing:16 * (firing + 1)] = \
                    img[col, ring_of_ch]
        pkts.append(pcap_io.make_vlp16_packet(azs, ranges))
    return pkts


def write_validation_pcap(path: str, n_sweeps: int, n_az: int = N_AZ
                          ) -> np.ndarray:
    """Write ``n_sweeps`` wire-format sweeps of the corridor on the
    turning trajectory to ``path``; returns the ground-truth positions
    at each sweep's end (LOAM camera frame)."""
    rects = synthetic.corridor_world()
    traj = synthetic.turning_trajectory(speed=1.0)
    pkts = []
    for k in range(n_sweeps):
        img, az_deg = range_image(rects, traj, 0.1 * k, n_az=n_az, seed=k)
        pkts.extend(packets_for_sweep(img, az_deg))
    pcap_io.write_pcap(path, pkts)
    end_times = 0.1 * (np.arange(n_sweeps) + 1)
    return synthetic.loam_frame_positions(
        traj, np.concatenate([[0.0], end_times]))[1:]


def main():
    n_sweeps = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    out = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".validation_data",
        "corridor_vlp16.pcap")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    gt = write_validation_pcap(out, n_sweeps)
    # ground truth for reporting (validate itself gates on the golden)
    np.savez_compressed(out + ".gt.npz", positions=gt)
    print(f"{out}: {n_sweeps} sweeps, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
