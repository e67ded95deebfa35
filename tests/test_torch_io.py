"""Port parity, the readers and writers: loam_velodyne_torch.io.rosbag,
.pcap, .kitti, .pcd, .lz4f, .native and
loam_velodyne_torch.tools.make_validation_pcap against the JAX package's
copies (and the repository's tools/make_validation_pcap.py), on the same
files, both ways: what the port's writers write, the JAX readers read,
and the other way round.

Tolerance: none. Readers turn the same bytes into numpy arrays by the
same operations, so every array, stamp and kind must be equal exactly
(``np.array_equal`` with the same dtype), and the two packages' writers
must write the same bytes. The native library (native/loamio.cc, built
by each package into its own directory) must give exactly the Python
readers' arrays on these files. The cases mirror tests/test_io.py,
tests/test_kitti_multilidar.py and tests/test_validate.py.
"""

import json
import os
import sys

import numpy as np
import pytest

from loam_velodyne_tpu.io import kitti as jkitti
from loam_velodyne_tpu.io import lz4f as jlz4f
from loam_velodyne_tpu.io import pcap as jpcap
from loam_velodyne_tpu.io import pcd as jpcd
from loam_velodyne_tpu.io import rosbag as jbag
from loam_velodyne_tpu.io import synthetic as jsyn
from loam_velodyne_torch.io import kitti as tkitti
from loam_velodyne_torch.io import lz4f as tlz4f
from loam_velodyne_torch.io import native as tnative
from loam_velodyne_torch.io import pcap as tpcap
from loam_velodyne_torch.io import pcd as tpcd
from loam_velodyne_torch.io import rosbag as tbag
from loam_velodyne_torch.io import synthetic as tsyn
from loam_velodyne_torch.tools import make_validation_pcap as tmk

BAG = {"jax": jbag, "port": tbag}
PCAP = {"jax": jpcap, "port": tpcap}
BOTH_WAYS = [("jax", "port"), ("port", "jax")]      # (writer, reader)


def _jax_tool():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import make_validation_pcap
    return make_validation_pcap


def _same(a, b):
    """Equal exactly: the same dtype, shape and values."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b)


def _messages(mod, path, **kw):
    """The messages a reader yields, or the error it raises (its text
    without the path): the native library reads bz2 chunks only where
    libbz2's header was found at its build."""
    try:
        return list(mod.read_messages(path, **kw))
    except ValueError as e:
        return str(e).replace(path, "<bag>")


def _same_messages(got, want):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1]
        _same(g[2], w[2])


def test_native_library_builds_in_its_own_directory():
    lib = tnative.load()
    assert lib is not None
    assert tnative._BUILD_DIR.endswith(os.path.join("build", "torch_native"))
    assert os.path.exists(tnative._LIB)


# ---------------------------------------------------------------------------
# rosbag
# ---------------------------------------------------------------------------

def _write_bag(mod, path, compression, rng):
    clouds = [rng.normal(size=(50, 3)).astype(np.float32) for _ in range(3)]
    with mod.BagWriter(path, compression=compression) as w:
        for k, c in enumerate(clouds):
            w.write_imu("/imu/data", 100.0 + 0.05 * k, (0, 0, 0, 1),
                        (0.1, 0.2, 9.8), (0.01, -0.02, 0.03))
            w.write_cloud("/velodyne_points", 100.0 + 0.1 * k, c)
    return clouds


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_writers_write_the_same_bytes(tmp_path, compression):
    paths = {}
    for name, mod in BAG.items():
        paths[name] = str(tmp_path / f"{name}.bag")
        _write_bag(mod, paths[name], compression, np.random.default_rng(0))
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_read_matches_jax(tmp_path, rng, compression, writer, reader,
                              native):
    """The reader of one package on the other's bag gives exactly what
    the writer's own package reads, with the same parser."""
    p = str(tmp_path / "test.bag")
    clouds = _write_bag(BAG[writer], p, compression, rng)
    got = _messages(BAG[reader], p, native=native)
    _same_messages(got, _messages(BAG[writer], p, native=native))
    if isinstance(got, str):
        assert native and compression == "bz2" and "libbz2" in got
        return
    got_clouds = [m[2] for m in got if m[0] == "cloud"]
    for c, exp in zip(got_clouds, clouds):
        _same(c, exp)
    imu = [m for m in got if m[0] == "imu"]
    assert len(imu) == 3
    _same(imu[0][2], np.array([0, 0, 0, 1, 0.1, 0.2, 9.8, 0.01, -0.02, 0.03]))


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_native_equals_python(tmp_path, rng, compression):
    p = str(tmp_path / "test.bag")
    _write_bag(tbag, p, compression, rng)
    nat = _messages(tbag, p, native=True)
    if isinstance(nat, str):
        # The library was built without libbz2: it says so.
        assert compression == "bz2" and "libbz2" in nat
        return
    _same_messages(nat, list(tbag.read_messages(p, native=False)))
    s_nat, t_nat = tbag.read_bag_sweeps(p, native=True)
    s_py, t_py = tbag.read_bag_sweeps(p, native=False)
    assert t_nat == t_py and len(s_nat) == len(s_py) == 3
    for a, b in zip(s_nat, s_py):
        _same(a, b)


def _write_multi_source_bag(mod, path, rng):
    """Two PointCloud2 topics, /imu/data and /imu/data_raw (zero
    orientation quaternion), as tests/test_io.py writes them."""
    main_clouds = [rng.normal(size=(40, 3)).astype(np.float32)
                   for _ in range(3)]
    with mod.BagWriter(path) as w:
        for k, c in enumerate(main_clouds):
            t = 100.0 + 0.1 * k
            w.write_imu("/imu/data_raw", t, (0, 0, 0, 0), (0.0, 0.0, 0.0))
            w.write_imu("/imu/data", t, (0, 0, 0, 1), (0.1, 0.2, 9.8))
            w.write_cloud("/other_lidar/points", t,
                          np.full((10, 3), 99.0, np.float32))
            w.write_cloud("/velodyne_points", t, c)
    return main_clouds


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_bag_exact_topic_binding(tmp_path, rng, writer, reader, native):
    p = str(tmp_path / "multi.bag")
    main_clouds = _write_multi_source_bag(BAG[writer], p, rng)
    kw = dict(cloud_topic="/velodyne_points", imu_topic="/imu/data",
              native=native)
    got = list(BAG[reader].read_messages(p, **kw))
    _same_messages(got, list(BAG[writer].read_messages(p, **kw)))
    clouds = [m for m in got if m[0] == "cloud"]
    imus = [m for m in got if m[0] == "imu"]
    assert len(clouds) == 3 and len(imus) == 3
    for (_, _, xyz), exp in zip(clouds, main_clouds):
        _same(xyz, exp)
    for _, _, vals in imus:
        _same(vals[:4], np.array([0.0, 0.0, 0.0, 1.0]))


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_bag_type_fallback_single_connection(tmp_path, rng, writer, reader,
                                             native):
    p = str(tmp_path / "fallback.bag")
    c0 = rng.normal(size=(20, 3)).astype(np.float32)
    with BAG[writer].BagWriter(p) as w:
        w.write_cloud("/lidar_a/points", 10.0, c0)
        w.write_cloud("/lidar_b/points", 10.1, np.full((5, 3), 7.0, np.float32))
        w.write_cloud("/lidar_a/points", 10.2, c0 + 1.0)
    kw = dict(cloud_topic="/velodyne_points", native=native)
    got = list(BAG[reader].read_messages(p, **kw))
    _same_messages(got, list(BAG[writer].read_messages(p, **kw)))
    assert len(got) == 2
    _same(got[0][2], c0)
    _same(got[1][2], c0 + 1.0)


def test_lz4f_roundtrip_both_ways():
    data = bytes(range(256)) * 500
    for w, r in ((jlz4f, tlz4f), (tlz4f, jlz4f)):
        comp = w.compress(data)
        assert comp == r.compress(data) and len(comp) < len(data)
        assert r.decompress(comp) == data


# ---------------------------------------------------------------------------
# pcap
# ---------------------------------------------------------------------------

def _sensor_packets(mod, model, dual=False):
    """tests/test_io.py's captures: 12 packets of 10 m returns at 2 deg a
    block, per sensor model; ``dual`` is the VLP-16 dual-return capture
    of same-azimuth (last, strongest) block pairs."""
    rng = np.random.default_rng(5)
    packets = []
    for p in range(12):
        ranges = rng.uniform(2.0, 50.0, (12, 32))
        ranges[rng.random((12, 32)) < 0.1] = 0.0
        if model == "HDL-64E":
            azs = [(p * 6 + b // 2) * 2.0 % 360.0 for b in range(12)]
            packets.append(mod.make_hdl64_packet(azs, ranges))
        elif dual:
            azs = [(p * 6 + b // 2) * 15.0 % 360.0 for b in range(12)]
            packets.append(mod.make_vlp16_packet(
                azs, ranges, return_mode=mod.RETURN_DUAL))
        else:
            azs = [(p * 12 + b) * (2.0 if model == "HDL-32" else 15.0) % 360.0
                   for b in range(12)]
            make = (mod.make_hdl32_packet if model == "HDL-32"
                    else mod.make_vlp16_packet)
            packets.append(make(azs, ranges))
    return packets


CAPTURES = [("VLP-16", False), ("VLP-16", True), ("HDL-32", False),
            ("HDL-64E", False)]
CAPTURE_IDS = ["vlp16", "vlp16_dual", "hdl32", "hdl64e"]


@pytest.mark.parametrize("model,dual", CAPTURES, ids=CAPTURE_IDS)
def test_pcap_writers_write_the_same_bytes(tmp_path, model, dual):
    paths = {}
    for name, mod in PCAP.items():
        pkts = _sensor_packets(mod, model, dual)
        assert pkts == _sensor_packets(PCAP["jax"], model, dual)
        paths[name] = str(tmp_path / f"{name}.pcap")
        mod.write_pcap(paths[name], pkts)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
@pytest.mark.parametrize("model,dual", CAPTURES, ids=CAPTURE_IDS)
def test_pcap_read_matches_jax(tmp_path, model, dual, writer, reader, native):
    p = str(tmp_path / "cap.pcap")
    pkts = _sensor_packets(PCAP[writer], model, dual)
    PCAP[writer].write_pcap(p, pkts)
    assert PCAP[reader].detect_model(pkts[0]) == model
    assert (PCAP[reader].detect_return_mode(pkts[0]) == PCAP[reader].RETURN_DUAL) == dual
    got, t_got = PCAP[reader].read_pcap_sweeps(p, None, native=native)
    want, t_want = PCAP[writer].read_pcap_sweeps(p, None, native=native)
    assert t_got == t_want and len(got) == len(want) >= 1
    for a, b in zip(got, want):
        _same(a, b)
    for payload in pkts[:2]:
        for a, b in zip(PCAP[reader]._decode_payload(payload),
                        PCAP[writer]._decode_payload(payload)):
            _same(a, b)


@pytest.mark.parametrize("model,dual", CAPTURES, ids=CAPTURE_IDS)
def test_pcap_native_equals_python(tmp_path, model, dual):
    p = str(tmp_path / "cap.pcap")
    tpcap.write_pcap(p, _sensor_packets(tpcap, model, dual))
    nat, _ = tpcap.read_pcap_sweeps(p, None, native=True)
    py, _ = tpcap.read_pcap_sweeps(p, None, native=False)
    assert len(nat) == len(py)
    for a, b in zip(nat, py):
        _same(a, b)


def test_pcap_calibration_matches_jax(tmp_path):
    """A per-unit elevation table (JSON and velodyne-YAML) parses to the
    same table and decodes to the same sweeps in both packages."""
    p = str(tmp_path / "cap.pcap")
    tpcap.write_pcap(p, _sensor_packets(tpcap, "VLP-16"))
    calib = np.asarray(tpcap.VLP16_ELEVATIONS_DEG) + 0.5
    cpath = str(tmp_path / "calib.json")
    with open(cpath, "w") as f:
        json.dump({"elevations_deg": calib.tolist()}, f)
    ypath = str(tmp_path / "calib.yaml")
    with open(ypath, "w") as f:
        for v in np.radians(calib):
            f.write(f"  - {{laser_id: 0, vert_correction: {v:.8f}}}\n")
    for path in (cpath, ypath):
        table = tpcap.load_calibration(path)
        _same(table, jpcap.load_calibration(path))
        got, _ = tpcap.read_pcap_sweeps(p, None, calibration=table)
        want, _ = jpcap.read_pcap_sweeps(p, None, calibration=table)
        base, _ = tpcap.read_pcap_sweeps(p, None, native=False)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        assert np.abs(got[0][:, 2] - base[0][:, 2]).max() > 0.01


def test_wire_format_generator_matches_jax_tool(tmp_path):
    """The port's wire-format generator writes the repository tool's
    packets byte for byte, and its capture decodes back to the
    simulator's sweep (tests/test_validate.py's check: within the 2 mm
    range quantization)."""
    jmk = _jax_tool()
    rects = tsyn.corridor_world()
    traj = tsyn.turning_trajectory(speed=1.0)
    img, az = tmk.range_image(rects, traj, 0.1, seed=1)
    jimg, jaz = jmk.range_image(jsyn.corridor_world(),
                                jsyn.turning_trajectory(speed=1.0), 0.1, seed=1)
    _same(img, jimg)
    _same(az, jaz)
    pkts = tmk.packets_for_sweep(img, az)
    assert pkts == jmk.packets_for_sweep(jimg, jaz)

    clean, caz = tmk.range_image(rects, traj, 0.0, n_az=1800, noise_std=0.0,
                                 dropout=0.0)
    dec = np.concatenate([tpcap._decode_payload(q, "VLP-16")[0]
                          for q in tmk.packets_for_sweep(clean, caz)])
    ref = tsyn.raycast_sweep(rects, traj, 0.0, n_azimuth=1800)
    assert abs(len(dec) - len(ref)) < 0.01 * len(ref)
    sub = dec[:: max(1, len(dec) // 256)].astype(np.float32)
    d = np.linalg.norm(sub[:, None, :] - ref[None, :, :], axis=-1).min(1)
    assert d.max() < 4e-3, d.max()

    p = str(tmp_path / "wire.pcap")
    gt = tmk.write_validation_pcap(p, 2)
    assert gt.shape == (2, 3)
    got, _ = tpcap.read_pcap_sweeps(p, None, native=True)
    want, _ = jpcap.read_pcap_sweeps(p, None, native=False)
    assert len(got) == 2
    for a, b in zip(got, want):
        _same(a, b)


# ---------------------------------------------------------------------------
# KITTI and PCD
# ---------------------------------------------------------------------------

KITTI = {"jax": jkitti, "port": tkitti}
PCD = {"jax": jpcd, "port": tpcd}


@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_kitti_bins_and_poses_match_jax(tmp_path, rng, writer, reader):
    scans = [rng.normal(size=(n, 3)).astype(np.float32) for n in (100, 7, 250)]
    for k, xyz in enumerate(scans):
        refl = None if k else rng.uniform(0, 1, len(xyz))
        KITTI[writer].write_velodyne_bin(str(tmp_path / f"{k:06d}.bin"), xyz, refl)
    (tmp_path / "notes.txt").write_text("not a scan")
    got, t_got = KITTI[reader].read_sequence(str(tmp_path))
    want, t_want = KITTI[writer].read_sequence(str(tmp_path))
    assert t_got == t_want == [0.0, 0.1, 0.2]
    for a, b, exp in zip(got, want, scans):
        _same(a, b)
        _same(a, exp)
    got, _ = KITTI[reader].read_sequence(str(tmp_path), limit=2)
    assert len(got) == 2
    _same(KITTI[reader].read_velodyne_bin(str(tmp_path / "000001.bin")), scans[1])

    rows = np.zeros((3, 12))
    rows[:, 0] = rows[:, 5] = rows[:, 10] = 1.0
    rows[1, 11], rows[2, 3], rows[2, 7] = 5.0, 1.5, -0.25
    p = str(tmp_path / "poses.txt")
    np.savetxt(p, rows)
    poses = KITTI[reader].read_poses(p)
    _same(poses, KITTI[writer].read_poses(p))
    pos = KITTI[reader].poses_to_loam_positions(poses)
    _same(pos, KITTI[writer].poses_to_loam_positions(poses))
    np.testing.assert_array_equal(pos[1], [0.0, 0.0, 5.0])
    np.testing.assert_array_equal(pos[2], [-1.5, 0.25, 0.0])


def test_kitti_bad_length_raises_in_both(tmp_path):
    p = str(tmp_path / "000000.bin")
    np.arange(5, dtype=np.float32).tofile(p)
    for mod in KITTI.values():
        with pytest.raises(ValueError, match="multiple of 4"):
            mod.read_velodyne_bin(p)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("writer,reader", BOTH_WAYS)
def test_pcd_roundtrip_matches_jax(tmp_path, rng, writer, reader, binary):
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    inten = rng.uniform(0, 16, 100).astype(np.float32)
    for with_i in (True, False):
        p = str(tmp_path / f"cloud_{writer}_{with_i}.pcd")
        PCD[writer].write_pcd(p, xyz, inten if with_i else None, binary=binary)
        q = str(tmp_path / f"cloud_{reader}_{with_i}.pcd")
        PCD[reader].write_pcd(q, xyz, inten if with_i else None, binary=binary)
        with open(p, "rb") as a, open(q, "rb") as b:
            assert a.read() == b.read()
        got_xyz, got_i = PCD[reader].read_pcd(p)
        want_xyz, want_i = PCD[writer].read_pcd(p)
        _same(got_xyz, want_xyz)
        if with_i:
            _same(got_i, want_i)
        else:
            assert got_i is None and want_i is None
        if binary:
            _same(got_xyz, xyz)
        else:
            np.testing.assert_allclose(got_xyz, xyz, rtol=0, atol=1e-5)
