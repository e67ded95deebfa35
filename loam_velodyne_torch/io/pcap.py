"""Velodyne PCAP capture reading (and writing, for fixtures).

The port's copy of ``loam_velodyne_tpu/io/pcap.py``.

Replaces the velodyne_driver + velodyne_pointcloud stack that feeds the
reference's /velodyne_points topic: decodes raw Velodyne UDP payloads
(1206 bytes: 12 blocks x [flag, azimuth/100 deg, 32 x (range*2mm,
reflectivity)]) into sensor-frame sweeps segmented at azimuth rollover.
Native C++ fast path (native/loamio.cc) with a numpy fallback.

Sensor models (the reference's MultiScanMapper family,
MultiScanRegistration.h:83-89):
- VLP-16:  block flag 0xEEFF, 2 firings x 16 channels per block,
           product id 0x22 in the factory footer byte.
- HDL-32E: block flag 0xEEFF, 1 firing x 32 channels per block,
           product id 0x21; interleaved elevation table per datasheet.
- HDL-64E: blocks alternate upper bank 0xEEFF (lasers 0-31) / lower
           bank 0xDDFF (lasers 32-63); no product id (pre-dates the
           factory bytes) — detected by the 0xDDFF flag. Real units
           carry per-unit elevation calibration; without a calibration
           file the NOMINAL evenly-spaced tables are used (upper
           +2.0..-8.33 deg, lower -8.83..-24.33 deg) — fine for ring
           binning, which only needs monotone vertical angles.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from loam_velodyne_torch.config import LidarConfig

VLP16_ELEVATIONS_DEG = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    np.float64)

HDL32_ELEVATIONS_DEG = np.array(
    [-30.67, -9.33, -29.33, -8.00, -28.00, -6.66, -26.66, -5.33,
     -25.33, -4.00, -24.00, -2.67, -22.67, -1.33, -21.33, 0.00,
     -20.00, 1.33, -18.67, 2.67, -17.33, 4.00, -16.00, 5.33,
     -14.67, 6.67, -13.33, 8.00, -12.00, 9.33, -10.67, 10.67],
    np.float64)

# Nominal (calibration-free) HDL-64E bank tables.
HDL64_UPPER_ELEVATIONS_DEG = np.linspace(2.0, -8.33, 32)
HDL64_LOWER_ELEVATIONS_DEG = np.linspace(-8.83, -24.33, 32)

_PCAP_MAGIC = 0xA1B2C3D4
_UDP_HEADER = 42
_PAYLOAD = 1206
_FLAG_UPPER = 0xEEFF
_FLAG_LOWER = 0xDDFF

_PRODUCT_IDS = {0x22: "VLP-16", 0x21: "HDL-32"}

# Factory byte 1204: return mode (VLP-16/HDL-32 manuals).
RETURN_STRONGEST = 0x37
RETURN_LAST = 0x38
RETURN_DUAL = 0x39


def detect_model(payload: bytes) -> str:
    """Sensor model of one 1206-byte payload."""
    for b in range(12):
        (flag,) = struct.unpack_from("<H", payload, b * 100)
        if flag == _FLAG_LOWER:
            return "HDL-64E"
    pid = payload[1205]
    return _PRODUCT_IDS.get(pid, "VLP-16")


def detect_return_mode(payload: bytes) -> int:
    """Return-mode factory byte (0x37 strongest / 0x38 last / 0x39
    dual). Pre-factory-byte sensors (HDL-64E) read as single-return."""
    mode = payload[1204]
    return mode if mode in (RETURN_STRONGEST, RETURN_LAST, RETURN_DUAL) \
        else RETURN_STRONGEST


def load_calibration(path: str) -> np.ndarray:
    """Per-unit laser calibration -> elevation table (deg), laser order.

    Accepts either a JSON file {"elevations_deg": [...]} or a
    velodyne_pointcloud-style YAML with `vert_correction` radians per
    laser (parsed textually — no yaml dependency in this image).
    """
    import json as _json
    import re
    text = open(path).read()
    try:
        data = _json.loads(text)
        return np.asarray(data["elevations_deg"], np.float64)
    except (ValueError, KeyError):
        pass
    vert = [float(m) for m in re.findall(
        r"vert_correction:\s*([-+0-9.eE]+)", text)]
    if not vert:
        raise ValueError(f"{path}: no elevations_deg / vert_correction")
    return np.degrees(np.asarray(vert, np.float64))


def _block_ranges(blk: bytes) -> np.ndarray:
    rec = np.frombuffer(blk, np.uint8, 96, 4)
    raw = (rec.reshape(32, 3)[:, 0].astype(np.uint16)
           | (rec.reshape(32, 3)[:, 1].astype(np.uint16) << 8))
    return raw.astype(np.float64) * 0.002


def _project(d: np.ndarray, elev_deg: np.ndarray, az_deg: float,
             pts: list, azs: list) -> None:
    ok = d > 0
    if not ok.any():
        return
    el = np.deg2rad(elev_deg[ok])
    azr = np.deg2rad(az_deg)
    dd = d[ok]
    ce = np.cos(el)
    pts.append(np.stack([dd * ce * np.cos(azr),
                         -dd * ce * np.sin(azr),
                         dd * np.sin(el)], axis=1))
    azs.append(np.full(int(ok.sum()), az_deg))


def _decode_payload(payload: bytes, model: Optional[str] = None,
                    calibration: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One 1206-byte payload -> (xyz (M,3), azimuth_deg (M,)).

    Dual-return captures (factory byte 0x39): blocks arrive in
    same-azimuth pairs, even = last return, odd = strongest return of
    the same firing sequence; the strongest-return block of each pair
    is kept so downstream framing matches single-return captures (the
    velodyne_pointcloud driver's default ring output).
    calibration: per-unit elevation table (deg) in laser order
    (load_calibration), overriding the nominal datasheet tables.
    """
    if model is None:
        model = detect_model(payload)
    dual = model in ("VLP-16", "HDL-32") \
        and detect_return_mode(payload) == RETURN_DUAL

    def elev_table(nominal, bank=None):
        if calibration is None:
            return nominal
        if bank == "lower":
            return calibration[32:64]
        return calibration[:len(nominal)]

    pts, azs = [], []
    for b in range(12):
        if dual and b % 2 == 0:
            continue                  # keep the strongest-return block
        blk = payload[b * 100:(b + 1) * 100]
        (flag, az_raw) = struct.unpack_from("<HH", blk, 0)
        if flag not in (_FLAG_UPPER, _FLAG_LOWER):
            continue
        az0 = az_raw / 100.0
        dist = _block_ranges(blk)
        if model == "VLP-16":
            # next distinct-azimuth block: +1 in single-return framing,
            # +2 in dual (pairs share an azimuth)
            stride = 2 if dual else 1
            if b + stride < 12:
                az1 = struct.unpack_from(
                    "<H", payload, (b + stride) * 100 + 2)[0] / 100.0
                if az1 < az0:
                    az1 += 360.0
            else:
                az1 = az0 + 0.4
            for firing in range(2):
                az = az0 + (az1 - az0) * 0.5 * firing
                _project(dist[firing * 16:(firing + 1) * 16],
                         elev_table(VLP16_ELEVATIONS_DEG), az, pts, azs)
        elif model == "HDL-32":
            _project(dist, elev_table(HDL32_ELEVATIONS_DEG), az0, pts, azs)
        else:  # HDL-64E: bank selected by the block flag
            if flag == _FLAG_UPPER:
                elev = elev_table(HDL64_UPPER_ELEVATIONS_DEG)
            else:
                elev = (HDL64_LOWER_ELEVATIONS_DEG if calibration is None
                        else calibration[32:64])
            _project(dist, elev, az0, pts, azs)
    if not pts:
        return np.zeros((0, 3)), np.zeros((0,))
    return np.concatenate(pts), np.concatenate(azs)


def _python_read(path: str, calibration: Optional[np.ndarray] = None
                 ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    with open(path, "rb") as f:
        gh = f.read(24)
        (magic,) = struct.unpack("<I", gh[:4])
        if magic == _PCAP_MAGIC:
            endian = "<"
        elif struct.unpack(">I", gh[:4])[0] == _PCAP_MAGIC:
            endian = ">"
        else:
            raise ValueError(f"{path}: not a pcap file")
        sweeps, rels = [], []
        cur_xyz, cur_az = [], []
        prev_az = None
        model = None
        while True:
            ph = f.read(16)
            if len(ph) < 16:
                break
            (_, _, incl, _) = struct.unpack(endian + "IIII", ph)
            data = f.read(incl)
            if len(data) < _UDP_HEADER + _PAYLOAD:
                continue
            payload = data[_UDP_HEADER:_UDP_HEADER + _PAYLOAD]
            if model is None:
                model = detect_model(payload)
            xyz, az = _decode_payload(payload, model, calibration)
            for i in range(len(az)):
                if prev_az is not None and az[i] < prev_az - 180.0:
                    sweeps.append(np.concatenate(cur_xyz)
                                  if cur_xyz else np.zeros((0, 3)))
                    a = np.concatenate(cur_az) if cur_az else np.zeros((0,))
                    rels.append(_rel_from_az(a))
                    cur_xyz, cur_az = [], []
                prev_az = az[i]
                cur_xyz.append(xyz[i:i + 1])
                cur_az.append(az[i:i + 1])
        if cur_xyz:
            sweeps.append(np.concatenate(cur_xyz))
            rels.append(_rel_from_az(np.concatenate(cur_az)))
    return ([s.astype(np.float32) for s in sweeps],
            [r.astype(np.float32) for r in rels])


def _rel_from_az(az: np.ndarray) -> np.ndarray:
    if len(az) == 0:
        return az
    rel = az - az[0]
    rel[rel < 0] += 360.0
    return rel / 360.0


def read_pcap_sweeps(path: str, lidar: LidarConfig, native: bool = True,
                     calibration: Optional[np.ndarray] = None
                     ) -> Tuple[List[np.ndarray], List[float]]:
    """Returns (sweeps, nominal_times). Native path when available.

    calibration: per-unit elevation table from load_calibration — routes
    to the python decoder (the native path uses the nominal tables).
    Dual-return captures (factory byte 0x39) are handled by both
    decoders: the strongest return of each same-azimuth block pair is
    kept, matching single-return framing.
    """
    import os
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if native and calibration is None:
        out = _native_read(path)
        if out is not None:
            sweeps = out
            return sweeps, [0.1 * i for i in range(len(sweeps))]
    sweeps, _rels = _python_read(path, calibration)
    return sweeps, [0.1 * i for i in range(len(sweeps))]


def _native_read(path: str):
    import ctypes
    from loam_velodyne_torch.io.native import load
    lib = load()
    if lib is None:
        return None
    h = lib.loam_pcap_open(path.encode())
    if not h:
        raise ValueError(f"{path}: not a pcap file")
    cap = 600000
    xyz = np.zeros((cap, 3), np.float32)
    rel = np.zeros((cap,), np.float32)
    sweeps = []
    try:
        while True:
            n = lib.loam_pcap_next_sweep(
                h, xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rel.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
            if n <= 0:
                break
            sweeps.append(xyz[:n].copy())
    finally:
        lib.loam_pcap_close(h)
    return sweeps


# ---------------------------------------------------------------------------
# Fixture writer
# ---------------------------------------------------------------------------

def write_pcap(path: str, packets: List[bytes]) -> None:
    """Write raw 1206-byte Velodyne payloads as a UDP pcap capture."""
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", _PCAP_MAGIC, 2, 4, 0, 0, 65535, 1))
        for i, payload in enumerate(packets):
            frame = b"\x00" * _UDP_HEADER + payload
            f.write(struct.pack("<IIII", i // 10, (i % 10) * 100000,
                                len(frame), len(frame)))
            f.write(frame)


def _packet(azimuths_deg: List[float], ranges_m: np.ndarray,
            flags: List[int], product_id: int,
            return_mode: int = RETURN_STRONGEST) -> bytes:
    out = b""
    for b in range(12):
        out += struct.pack("<HH", flags[b],
                           int(round(azimuths_deg[b] * 100)))
        for ch in range(32):
            raw = int(round(ranges_m[b, ch] / 0.002))
            out += struct.pack("<HB", raw & 0xFFFF, 50)
    out += struct.pack("<IBB", 0, return_mode, product_id)
    return out


def make_vlp16_packet(azimuths_deg: List[float], ranges_m: np.ndarray,
                      return_mode: int = RETURN_STRONGEST) -> bytes:
    """Build one VLP-16 payload. azimuths_deg: 12 block azimuths;
    ranges_m: (12, 32) ranges in meters (0 = no return). In dual mode
    (return_mode=RETURN_DUAL) supply same-azimuth block pairs
    (last, strongest) as the sensor does."""
    return _packet(azimuths_deg, ranges_m, [_FLAG_UPPER] * 12, 0x22,
                   return_mode)


def make_hdl32_packet(azimuths_deg: List[float], ranges_m: np.ndarray,
                      return_mode: int = RETURN_STRONGEST) -> bytes:
    """Build one HDL-32E payload (12 blocks x 32 channels)."""
    return _packet(azimuths_deg, ranges_m, [_FLAG_UPPER] * 12, 0x21,
                   return_mode)


def make_hdl64_packet(azimuths_deg: List[float],
                      ranges_m: np.ndarray) -> bytes:
    """Build one HDL-64E payload: blocks alternate upper/lower bank,
    pairs sharing an azimuth. azimuths_deg: 12 block azimuths (pairs
    should repeat); ranges_m: (12, 32)."""
    flags = [_FLAG_UPPER if b % 2 == 0 else _FLAG_LOWER for b in range(12)]
    return _packet(azimuths_deg, ranges_m, flags, 0x00)
