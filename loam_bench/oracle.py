"""The benchmark's plain reference: a sequential NumPy transliteration of
the reference LOAM pipeline (laboshinl/loam_velodyne, the C++ that the
port rebuilds), written apart from the port and importing nothing of it.

Every routine cites the C++ source it transliterates:

- ingest:              MultiScanRegistration.cpp:157-236
- feature extraction:  BasicScanRegistration.cpp:153-386
- odometry:            BasicLaserOdometry.cpp:196-664
- mapping:             BasicLaserMapping.cpp:103-923
- maintenance:         BasicTransformMaintenance.cpp:46-178
- rotations:           src/lib/math_utils.h:129-275
- voxel grid:          pcl::VoxelGrid (centroid per cell, ascending
                       cell-index output order)

Pose-composition functions (accumulateRotation, pluginIMURotation, the
rotation part of transformAssociateToMap) are the rotation-matrix
products their trig expansions expand to. The IMU state machine
(BasicScanRegistration.cpp:82-152, 258-281; BasicLaserOdometry.cpp:218,
626-649; BasicLaserMapping.cpp:171-203) is modelled; without an
``OracleImu`` every IMU term is zero, as in the default launch.

It mirrors the C++'s control flow (sequential loops, push_back lists),
not the port's vectorised, fixed-capacity design: its maps are
unbounded, as the C++'s are. Three loops are written as array
operations with the same results (the 1-NN and 5-NN searches, odometry's
search along the neighbouring rings, ``transformToEnd``), so that a
stretch of sweeps at a sensor's real density takes seconds, not minutes.

``OracleParams.of(loam)`` takes the parameters from a configuration's
``loam`` section; ``follow(loam, sweeps)`` runs a fresh pipeline over a
stretch of sweeps and returns what a user of each sweep sees: the
odometry, mapped and fused poses, and the rows the configuration's
capacities shed at ingest and in the features (``shed``).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


# ---------------------------------------------------------------------------
# math_utils.h rotations (reference :129-275). rotateZXY applies Z, X,
# then Y; as matrices: R = Ry @ Rx @ Rz.
# ---------------------------------------------------------------------------

def rot_x_mat(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_y_mat(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rot_z_mat(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rot_zxy(rx, ry, rz):
    """Matrix of rotateZXY(v, rz, rx, ry)."""
    return rot_y_mat(ry) @ rot_x_mat(rx) @ rot_z_mat(rz)


def _rot_rows(v, a, axis):
    """Each row of ``v`` (n, 3) turned by its own angle ``a`` about
    ``axis``: the rows' ``rot_x_mat`` / ``rot_y_mat`` / ``rot_z_mat``."""
    c, s = np.cos(a), np.sin(a)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    if axis == 0:
        return np.stack([x, c * y - s * z, s * y + c * z], axis=1)
    if axis == 1:
        return np.stack([c * x + s * z, y, -s * x + c * z], axis=1)
    return np.stack([c * x - s * y, s * x + c * y, z], axis=1)


def euler_zxy(m):
    """Angles (rx, ry, rz) with rot_zxy(rx, ry, rz) == m, extracted the
    way the reference's -asin / atan2 chains do."""
    rx = -math.asin(np.clip(m[1, 2], -1.0, 1.0))
    ry = math.atan2(m[0, 2], m[2, 2])
    rz = math.atan2(m[1, 0], m[1, 1])
    return np.array([rx, ry, rz])


def accumulate_rotation(c_ang, l_ang):
    """BasicLaserOdometry::accumulateRotation (:155-179): the trig blob
    is the expansion of euler(R(c) @ R(l)) (verified in test_oracle)."""
    return euler_zxy(rot_zxy(*c_ang) @ rot_zxy(*l_ang))


def plugin_imu_rotation(bc, bl, al):
    """BasicLaserOdometry::pluginIMURotation (:91-151):
    euler(R(bc) @ R(bl)^T @ R(al))."""
    return euler_zxy(rot_zxy(*bc) @ rot_zxy(*bl).T @ rot_zxy(*al))


def transform_associate_to_map(sum6, bef6, aft6):
    """BasicLaserMapping::transformAssociateToMap (:103-167) ==
    BasicTransformMaintenance::transformAssociateToMap (:83-178)."""
    # incre.pos = rotateYXZ(bef.pos - sum.pos, -sum_ry, -sum_rx, -sum_rz)
    incre = (rot_z_mat(-sum6[2]) @ rot_x_mat(-sum6[0]) @ rot_y_mat(-sum6[1])
             @ (bef6[3:] - sum6[3:]))
    rot = euler_zxy(rot_zxy(*aft6[:3]) @ rot_zxy(*bef6[:3]).T
                    @ rot_zxy(*sum6[:3]))
    pos = aft6[3:] - rot_zxy(*rot) @ incre
    return np.concatenate([rot, pos])


# ---------------------------------------------------------------------------
# pcl::VoxelGrid transliteration: floor(p/leaf) cells, centroid per
# cell, output ordered by ascending linear cell index.
# ---------------------------------------------------------------------------

def voxel_grid(points, leaf):
    """points: (N, >=3); returns downsampled copy (centroid of xyz AND
    the extra columns, like PCL's centroid-of-all-fields default)."""
    if len(points) == 0:
        return points.copy()
    ijk = np.floor(points[:, :3] / leaf).astype(np.int64)
    mn = ijk.min(axis=0)
    rel = ijk - mn
    div = rel.max(axis=0) + 1
    lin = rel[:, 0] + rel[:, 1] * div[0] + rel[:, 2] * div[0] * div[1]
    order = np.argsort(lin, kind="stable")
    lin_s = lin[order]
    pts_s = points[order]
    starts = np.flatnonzero(np.concatenate([[True], lin_s[1:] != lin_s[:-1]]))
    ends = np.concatenate([starts[1:], [len(lin_s)]])
    out = np.stack([pts_s[a:b].mean(axis=0) for a, b in zip(starts, ends)])
    return out


def knn(query, cloud, k):
    """Exact k-NN (indices, squared distances), ascending — what
    nanoflann::KdTreeFLANN returns."""
    d2 = np.sum((cloud[:, :3] - query[None, :3]) ** 2, axis=1)
    if k == 1 and len(d2):
        idx = np.array([np.argmin(d2)])
    elif k < len(d2):
        # The k smallest and every tie of the largest of them, then a
        # stable sort: the stable argsort's first k, in less time.
        kth = d2[np.argpartition(d2, k - 1)[:k]].max()
        cand = np.flatnonzero(d2 <= kth)
        idx = cand[np.argsort(d2[cand], kind="stable")[:k]]
    else:
        idx = np.argsort(d2, kind="stable")[:k]
    return idx, d2[idx]


def degeneracy_projector(ata, threshold):
    """The C++'s degeneracy projection (BasicLaserOdometry.cpp:575-588,
    BasicLaserMapping.cpp:880-896): ``matP = matV.inv() * matV2``, where
    the rows of ``matV`` are the eigenvectors of ``ata`` and ``matV2``
    zeroes those whose eigenvalue lies below ``threshold``, walking up from
    the smallest until one does not. With NumPy's eigenvectors in columns
    (ascending) that is the sum of v v^T over the kept ones.
    Returns (the projector, whether a direction was dropped)."""
    w, v = np.linalg.eigh(ata)
    kept = v.copy()
    dropped = False
    for d in range(6):
        if w[d] < threshold:
            kept[:, d] = 0
            dropped = True
        else:
            break
    return kept @ v.T, dropped


def ring_window(scans, ci, jmax, bracket=2.5):
    """The rows that odometry's search along the neighbouring rings
    visits from the nearest row ``ci`` (BasicLaserOdometry.cpp:254-300),
    in its order: up from ``ci + 1`` below ``jmax`` until a row lies past
    ``bracket`` rings above, then down from ``ci - 1`` until one lies past
    ``bracket`` rings below. Returns (rows, how many go up)."""
    closest = scans[ci]
    up = np.arange(ci + 1, max(jmax, ci + 1))
    stop = np.flatnonzero(scans[up] > closest + bracket)
    if len(stop):
        up = up[:stop[0]]
    down = np.arange(ci - 1, -1, -1)
    stop = np.flatnonzero(scans[down] < closest - bracket)
    if len(stop):
        down = down[:stop[0]]
    return np.concatenate([up, down]), len(up)


def first_min(d2, ok, bound):
    """The first row, in visiting order, of the least ``d2`` among rows
    ``ok`` below ``bound`` (a loop keeping a strictly smaller one), or -1."""
    d = np.where(ok, d2, np.inf)
    if not len(d):
        return -1
    i = int(np.argmin(d))
    return i if d[i] < bound else -1


# ---------------------------------------------------------------------------
# IMU state machine: BasicScanRegistration (:82-152, :258-281)
# ---------------------------------------------------------------------------

class OracleImu:
    """IMU history with world-frame dead-reckoning integration
    (updateIMUData, BasicScanRegistration.cpp:82-98) and the reference's
    walk-and-lerp interpolation (interpolateIMUStateFor, :138-152).

    push() takes (stamp, (roll, pitch, yaw), gravity-free acceleration
    in the swapped camera frame) — i.e. after the handleIMUMessage axis
    swap + gravity removal (ScanRegistration.cpp:164-184)."""

    def __init__(self):
        self.stamps: list = []
        self.rpy: list = []      # (roll, pitch, yaw)
        self.velo: list = []
        self.pos: list = []

    def push(self, stamp, rpy, acc_swapped):
        # rotateZXY(acc, roll, pitch, yaw) == Ry(yaw) Rx(pitch) Rz(roll)
        acc_world = rot_zxy(rpy[1], rpy[2], rpy[0]) @ np.asarray(acc_swapped,
                                                                 np.float64)
        if self.stamps:
            dt = stamp - self.stamps[-1]
            pos = self.pos[-1] + self.velo[-1] * dt + 0.5 * acc_world * dt * dt
            velo = self.velo[-1] + acc_world * dt
        else:
            pos, velo = np.zeros(3), np.zeros(3)
        self.stamps.append(float(stamp))
        self.rpy.append(np.asarray(rpy, np.float64))
        self.velo.append(velo)
        self.pos.append(pos)

    def has_data(self):
        return bool(self.stamps)

    def interpolate(self, query_time):
        """(roll, pitch, yaw), velo, pos at an absolute time, with the
        reference's end clamping + yaw wrap (:138-152, IMUState::interpolate)."""
        idx = 0
        n = len(self.stamps)
        while idx < n - 1 and query_time - self.stamps[idx] > 0:
            idx += 1
        if idx == 0 or query_time - self.stamps[idx] > 0:
            return (self.rpy[idx].copy(), self.velo[idx].copy(),
                    self.pos[idx].copy())
        ratio = (self.stamps[idx] - query_time) \
            / (self.stamps[idx] - self.stamps[idx - 1])
        new, old = idx, idx - 1
        inv = 1 - ratio
        y_new, y_old = self.rpy[new][2], self.rpy[old][2]
        if y_new - y_old > math.pi:
            y_old += 2 * math.pi
        elif y_new - y_old < -math.pi:
            y_old -= 2 * math.pi
        rpy = np.array([self.rpy[new][0] * inv + self.rpy[old][0] * ratio,
                        self.rpy[new][1] * inv + self.rpy[old][1] * ratio,
                        y_new * inv + y_old * ratio])
        velo = self.velo[new] * inv + self.velo[old] * ratio
        pos = self.pos[new] * inv + self.pos[old] * ratio
        return rpy, velo, pos


class ImuTrans:
    """The 4-point imuTrans summary (updateIMUTransform, :258-281).
    Angle triplets are stored in (x, y, z)=(pitch, yaw, roll) order,
    exactly as packed into the imuTrans cloud."""

    def __init__(self):
        self.start_pyr = np.zeros(3)
        self.end_pyr = np.zeros(3)
        self.shift_from_start = np.zeros(3)
        self.velo_from_start = np.zeros(3)


# ---------------------------------------------------------------------------
# Ingest: MultiScanRegistration::process (:157-236)
# ---------------------------------------------------------------------------

class OracleParams:
    scan_period = 0.1
    n_rings = 16
    lower_bound = -15.0
    upper_bound = 15.0
    n_feature_regions = 6
    curvature_region = 5
    max_corner_sharp = 2
    max_surface_flat = 4
    less_flat_filter_size = 0.2
    surface_curvature_threshold = 0.1
    # odometry
    odo_max_iterations = 25
    odo_delta_t_abort = 0.1
    odo_delta_r_abort = 0.1
    io_ratio = 2
    # mapping
    map_max_iterations = 10
    map_delta_abort = 0.05
    corner_leaf = 0.2
    surf_leaf = 0.4
    grid_w, grid_h, grid_d = 21, 11, 21
    cen_w, cen_h, cen_d = 10, 5, 10
    cube_size = 50.0
    recenter_margin = 3
    neighborhood = 2
    odo_min_corner, odo_min_surf, odo_min_selected = 10, 100, 10
    map_min_corner, map_min_surf, map_min_selected = 10, 100, 50
    odo_refresh_every = 5
    odo_degeneracy, map_degeneracy = 10.0, 100.0

    @classmethod
    def of(cls, loam: dict) -> "OracleParams":
        """The parameters of a configuration's ``loam`` section."""
        lid, reg = loam["lidar"], loam["registration"]
        odo, m = loam["odometry"], loam["mapping"]
        p = cls()
        p.scan_period = reg["scan_period"]
        p.n_rings = lid["n_rings"]
        p.lower_bound = lid["lower_bound_deg"]
        p.upper_bound = lid["upper_bound_deg"]
        for k in ("n_feature_regions", "curvature_region", "max_corner_sharp",
                  "max_surface_flat", "less_flat_filter_size",
                  "surface_curvature_threshold"):
            setattr(p, k, reg[k])
        p.odo_max_iterations = odo["max_iterations"]
        p.odo_delta_t_abort = odo["delta_t_abort"]
        p.odo_delta_r_abort = odo["delta_r_abort"]
        p.io_ratio = odo["io_ratio"]
        p.odo_min_corner = odo["min_corner_points"]
        p.odo_min_surf = odo["min_surface_points"]
        p.odo_min_selected = odo["min_selected"]
        p.map_min_corner = m["min_corner_map_points"]
        p.map_min_surf = m["min_surface_map_points"]
        p.map_min_selected = m["min_selected"]
        p.odo_refresh_every = odo["corresp_refresh_every"]
        p.odo_degeneracy = odo["degeneracy_eigen_threshold"]
        p.map_degeneracy = m["degeneracy_eigen_threshold"]
        p.map_max_iterations = m["max_iterations"]
        p.map_delta_abort = m["delta_t_abort"]
        p.corner_leaf, p.surf_leaf = m["corner_leaf"], m["surf_leaf"]
        p.grid_w, p.grid_h, p.grid_d = (m["grid_width"], m["grid_height"],
                                        m["grid_depth"])
        p.cen_w, p.cen_h, p.cen_d = (m["center_width"], m["center_height"],
                                     m["center_depth"])
        p.cube_size = m["cube_size"]
        p.recenter_margin = m["recenter_margin"]
        p.neighborhood = m["neighborhood"]
        p.points_per_ring = lid["max_points_per_ring"]
        p.caps = dict(loam["capacities"])
        return p

    @property
    def max_corner_less_sharp(self):
        return 10 * self.max_corner_sharp

    @property
    def ring_factor(self):
        return (self.n_rings - 1) / (self.upper_bound - self.lower_bound)


def ingest(pts_in, p: OracleParams, imu: OracleImu | None = None,
           scan_time: float = 0.0):
    """Sensor-frame (N,3) -> per-ring lists of (x,y,z,intensity) rows in
    the swapped camera frame, intensity = ringID + relTime.

    With an ``imu``, each point is additionally deskewed to the
    sweep-start IMU frame (projectPointToStartOfSweep +
    transformToStartIMU, BasicScanRegistration.cpp:101-134) and the
    (rings, imu_trans) pair is returned (updateIMUTransform, :258-281).
    """
    n = len(pts_in)
    start_ori = -math.atan2(pts_in[0][1], pts_in[0][0])
    end_ori = -math.atan2(pts_in[-1][1], pts_in[-1][0]) + 2 * math.pi
    if end_ori - start_ori > 3 * math.pi:
        end_ori -= 2 * math.pi
    elif end_ori - start_ori < math.pi:
        end_ori += 2 * math.pi

    use_imu = imu is not None and imu.has_data()
    trans = ImuTrans()
    if use_imu:
        rpy_s, velo_s, pos_s = imu.interpolate(scan_time)
        r_start = rot_zxy(rpy_s[1], rpy_s[2], rpy_s[0])  # Ry(yaw)Rx(p)Rz(r)
        rpy_c, velo_c, pos_c = rpy_s, velo_s, pos_s
        shift_cur = np.zeros(3)

    rings: List[list] = [[] for _ in range(p.n_rings)]
    half_passed = False
    for i in range(n):
        x, y, z = pts_in[i][1], pts_in[i][2], pts_in[i][0]
        if not (math.isfinite(x) and math.isfinite(y) and math.isfinite(z)):
            continue
        if x * x + y * y + z * z < 0.0001:
            continue
        angle = math.atan(y / math.sqrt(x * x + z * z))
        ring = int(round((math.degrees(angle) - p.lower_bound)
                         * p.ring_factor))
        if ring < 0 or ring >= p.n_rings:
            continue
        ori = -math.atan2(x, z)
        if not half_passed:
            if ori < start_ori - math.pi / 2:
                ori += 2 * math.pi
            elif ori > start_ori + math.pi * 3 / 2:
                ori -= 2 * math.pi
            if ori - start_ori > math.pi:
                half_passed = True
        else:
            ori += 2 * math.pi
            if ori < end_ori - math.pi * 3 / 2:
                ori += 2 * math.pi
            elif ori > end_ori + math.pi / 2:
                ori -= 2 * math.pi
        rel_time = p.scan_period * (ori - start_ori) / (end_ori - start_ori)
        pt = np.array([x, y, z])
        if use_imu:
            # setIMUTransformFor (:113-119) + transformToStartIMU (:122-134)
            rpy_c, velo_c, pos_c = imu.interpolate(scan_time + rel_time)
            shift_cur = pos_c - pos_s - velo_s * rel_time
            pt = rot_zxy(rpy_c[1], rpy_c[2], rpy_c[0]) @ pt + shift_cur
            pt = r_start.T @ pt
        rings[ring].append((pt[0], pt[1], pt[2], ring + rel_time))

    rings = [np.array(r, np.float64).reshape(-1, 4) for r in rings]
    if use_imu:
        # updateIMUTransform packs (pitch, yaw, roll) into xyz (:258-281)
        trans.start_pyr = np.array([rpy_s[1], rpy_s[2], rpy_s[0]])
        trans.end_pyr = np.array([rpy_c[1], rpy_c[2], rpy_c[0]])
        trans.shift_from_start = r_start.T @ shift_cur
        trans.velo_from_start = r_start.T @ (velo_c - velo_s)
    return rings, trans


# ---------------------------------------------------------------------------
# Feature extraction: BasicScanRegistration (:153-386)
# ---------------------------------------------------------------------------

def _sq_diff(a, b, weight=1.0):
    d = a[:3] - b[:3] * weight if weight != 1.0 else a[:3] - b[:3]
    return float(d @ d)


def extract_features(rings, p: OracleParams):
    sharp, less_sharp, flat = [], [], []
    less_flat = []
    cloud = np.concatenate([r for r in rings if len(r)] or
                           [np.zeros((0, 4))])
    # scan index ranges over the concatenated cloud
    ranges = []
    off = 0
    for r in rings:
        ranges.append((off, off + len(r) - 1))
        off += len(r)

    C = p.curvature_region
    for (s0, e0) in ranges:
        if e0 <= s0 + 2 * C:
            continue
        scan_less_flat = []
        # setScanBuffersFor (:321-363)
        n_scan = e0 - s0 + 1
        picked = np.zeros(n_scan, np.int32)
        for i in range(s0 + C, e0 - C):
            prev_pt, pt, next_pt = cloud[i - 1], cloud[i], cloud[i + 1]
            diff_next = _sq_diff(next_pt, pt)
            if diff_next > 0.1:
                d1 = math.sqrt(pt[:3] @ pt[:3])
                d2 = math.sqrt(next_pt[:3] @ next_pt[:3])
                if d1 > d2:
                    wd = math.sqrt(
                        float(np.sum((next_pt[:3] - pt[:3] * (d2 / d1)) ** 2))) / d2
                    if wd < 0.1:
                        picked[i - s0 - C:i - s0 + 1] = 1
                        continue
                else:
                    wd = math.sqrt(
                        float(np.sum((pt[:3] - next_pt[:3] * (d1 / d2)) ** 2))) / d1
                    if wd < 0.1:
                        picked[i - s0 + 1:i - s0 + C + 2] = 1
            diff_prev = _sq_diff(pt, prev_pt)
            dis = float(pt[:3] @ pt[:3])
            if diff_next > 0.0002 * dis and diff_prev > 0.0002 * dis:
                picked[i - s0] = 1

        def mark_as_picked(idx, scan_idx):
            picked[scan_idx] = 1
            for j in range(1, C + 1):
                if _sq_diff(cloud[idx + j], cloud[idx + j - 1]) > 0.05:
                    break
                picked[scan_idx + j] = 1
            for j in range(1, C + 1):
                if _sq_diff(cloud[idx - j], cloud[idx - j + 1]) > 0.05:
                    break
                picked[scan_idx - j] = 1

        for j in range(p.n_feature_regions):
            sp = ((s0 + C) * (p.n_feature_regions - j)
                  + (e0 - C) * j) // p.n_feature_regions
            ep = ((s0 + C) * (p.n_feature_regions - 1 - j)
                  + (e0 - C) * (j + 1)) // p.n_feature_regions - 1
            if ep <= sp:
                continue
            region_size = ep - sp + 1
            # setRegionBuffersFor (:284-318): curvature + stable
            # ascending sort (the insertion sort is stable)
            curv = np.empty(region_size)
            for i in range(sp, ep + 1):
                diff = -2 * C * cloud[i][:3].copy()
                for k in range(1, C + 1):
                    diff += cloud[i + k][:3] + cloud[i - k][:3]
                curv[i - sp] = float(diff @ diff)
            label = np.zeros(region_size, np.int32)  # 0 = SURFACE_LESS_FLAT
            sort_idx = np.argsort(curv, kind="stable") + sp

            # corner picks (:196-217), walking from largest curvature
            largest = 0
            for k in range(region_size - 1, -1, -1):
                if largest >= p.max_corner_less_sharp:
                    break
                idx = int(sort_idx[k])
                scan_idx = idx - s0
                region_idx = idx - sp
                if picked[scan_idx] == 0 and \
                        curv[region_idx] > p.surface_curvature_threshold:
                    largest += 1
                    if largest <= p.max_corner_sharp:
                        label[region_idx] = 2      # CORNER_SHARP
                        sharp.append(cloud[idx])
                    else:
                        label[region_idx] = 1      # CORNER_LESS_SHARP
                    less_sharp.append(cloud[idx])
                    mark_as_picked(idx, scan_idx)

            # flat picks (:219-235)
            smallest = 0
            for k in range(region_size):
                if smallest >= p.max_surface_flat:
                    break
                idx = int(sort_idx[k])
                scan_idx = idx - s0
                region_idx = idx - sp
                if picked[scan_idx] == 0 and \
                        curv[region_idx] < p.surface_curvature_threshold:
                    smallest += 1
                    label[region_idx] = -1         # SURFACE_FLAT
                    flat.append(cloud[idx])
                    mark_as_picked(idx, scan_idx)

            # less-flat candidates (:238-242): label <= SURFACE_LESS_FLAT
            for k in range(region_size):
                if label[k] <= 0:
                    scan_less_flat.append(cloud[sp + k])

        if scan_less_flat:
            ds = voxel_grid(np.stack(scan_less_flat), p.less_flat_filter_size)
            less_flat.append(ds)

    def pack(rows):
        return (np.stack(rows) if rows else np.zeros((0, 4)))

    return (pack(sharp), pack(less_sharp), pack(flat),
            np.concatenate(less_flat) if less_flat else np.zeros((0, 4)))


# ---------------------------------------------------------------------------
# Odometry: BasicLaserOdometry (:196-664)
# ---------------------------------------------------------------------------

class OracleOdometry:
    def __init__(self, p: OracleParams):
        self.p = p
        self.inited = False
        self.transform = np.zeros(6)      # per-sweep motion estimate
        self.transform_sum = np.zeros(6)  # accumulated pose
        self.last_corner = np.zeros((0, 4))
        self.last_surf = np.zeros((0, 4))
        self.imu = ImuTrans()             # updateIMU (:181-194)

    def _to_start(self, pt):
        """transformToStart (:40-53)."""
        s = (1.0 / self.p.scan_period) * (pt[3] - int(pt[3]))
        po = pt[:3] - s * self.transform[3:]
        r = -s * self.transform[:3]
        return rot_zxy(r[0], r[1], r[2]) @ po

    def _to_end(self, cloud):
        """transformToEnd (:58-87), including the IMU start/end terms, over
        every row at once."""
        out = cloud.copy()
        ps, ys, rs = self.imu.start_pyr
        pe, ye, re = self.imu.end_pyr
        r_start = rot_zxy(ps, ys, rs)
        r_end = rot_zxy(pe, ye, re)
        ring = np.trunc(cloud[:, 3])
        s = (1.0 / self.p.scan_period) * (cloud[:, 3] - ring)
        po = cloud[:, :3] - s[:, None] * self.transform[3:]
        r = -s[:, None] * self.transform[:3]
        # rotateZXY per row: Rz(r2), then Rx(r0), then Ry(r1)
        po = _rot_rows(po, r[:, 2], 2)
        po = _rot_rows(po, r[:, 0], 0)
        po = _rot_rows(po, r[:, 1], 1)
        # rotateYXZ(point, ry, rx, rz) then add pos
        m = (rot_z_mat(self.transform[2]) @ rot_x_mat(self.transform[0])
             @ rot_y_mat(self.transform[1]))
        po = po @ m.T + self.transform[3:]
        po = po - self.imu.shift_from_start
        # rotateZXY(pt, rollS, pitchS, yawS); rotateYXZ(pt, -yawE,
        # -pitchE, -rollE) (:81-84) — identity when IMU absent
        po = po @ (r_end.T @ r_start).T
        out[:, :3] = po
        out[:, 3] = ring
        return out

    def process(self, sharp, less_sharp, flat, less_flat,
                imu_trans: ImuTrans | None = None):
        p = self.p
        self.imu = imu_trans or ImuTrans()
        if not self.inited:
            self.last_corner = less_sharp
            self.last_surf = less_flat
            # seed attitude from the IMU (:207-208)
            self.transform_sum[0] += self.imu.start_pyr[0]
            self.transform_sum[2] += self.imu.start_pyr[2]
            self.inited = True
            return self.transform_sum.copy()

        # motion prior from the IMU velocity drift (:218)
        self.transform[3:] -= self.imu.velo_from_start * p.scan_period

        n_sharp = len(sharp)
        n_flat = len(flat)
        corner_i1 = np.full(n_sharp, -1, np.int64)
        corner_i2 = np.full(n_sharp, -1, np.int64)
        surf_i1 = np.full(n_flat, -1, np.int64)
        surf_i2 = np.full(n_flat, -1, np.int64)
        surf_i3 = np.full(n_flat, -1, np.int64)
        is_degenerate = False
        mat_p = np.eye(6)

        corner_scans = np.trunc(self.last_corner[:, 3]).astype(np.int64)
        surf_scans = np.trunc(self.last_surf[:, 3]).astype(np.int64)
        if (len(self.last_corner) > p.odo_min_corner
                and len(self.last_surf) > p.odo_min_surf):
            for it in range(p.odo_max_iterations):
                ori_rows, coeff_rows = [], []

                for i in range(n_sharp):
                    psel = self._to_start(sharp[i])
                    if it % p.odo_refresh_every == 0:
                        nn_idx, nn_d2 = knn(psel, self.last_corner, 1)
                        ci, mi2 = -1, -1
                        if nn_d2[0] < 25:
                            ci = int(nn_idx[0])
                            # The C++ walks up only while j <
                            # cornerPointsSharpNum, over the LAST cloud
                            # (BasicLaserOdometry.cpp:262), an accident
                            # that the port does not reproduce: the walk
                            # covers the whole cloud.
                            jmax = len(self.last_corner)
                            rows, n_up = ring_window(corner_scans, ci, jmax)
                            d2 = np.sum((self.last_corner[rows, :3] - psel)
                                        ** 2, axis=1)
                            sc, closest = corner_scans[rows], corner_scans[ci]
                            up = np.arange(len(rows)) < n_up
                            j = first_min(d2, np.where(up, sc > closest,
                                                       sc < closest), 25.0)
                            mi2 = int(rows[j]) if j >= 0 else -1
                        corner_i1[i], corner_i2[i] = ci, mi2

                    if corner_i2[i] >= 0:
                        a = self.last_corner[corner_i1[i]][:3]
                        b = self.last_corner[corner_i2[i]][:3]
                        cvec = np.cross(psel - a, psel - b)
                        a012 = float(np.linalg.norm(cvec))
                        l12 = float(np.linalg.norm(a - b))
                        if a012 == 0 or l12 == 0:
                            continue
                        ld2 = a012 / l12
                        direction = np.cross(a - b, cvec / a012) / l12
                        s = 1.0
                        if it >= 5:
                            s = 1 - 1.8 * abs(ld2)
                        if s > 0.1 and ld2 != 0:
                            ori_rows.append(sharp[i])
                            coeff_rows.append(
                                np.concatenate([s * direction, [s * ld2]]))

                for i in range(n_flat):
                    psel = self._to_start(flat[i])
                    if it % p.odo_refresh_every == 0:
                        nn_idx, nn_d2 = knn(psel, self.last_surf, 1)
                        ci, mi2, mi3 = -1, -1, -1
                        if nn_d2[0] < 25:
                            ci = int(nn_idx[0])
                            jmax = len(self.last_surf)   # as the corner walk
                            rows, n_up = ring_window(surf_scans, ci, jmax)
                            d2 = np.sum((self.last_surf[rows, :3] - psel)
                                        ** 2, axis=1)
                            sc, closest = surf_scans[rows], surf_scans[ci]
                            up = np.arange(len(rows)) < n_up
                            same = np.where(up, sc <= closest, sc >= closest)
                            j = first_min(d2, same, 25.0)
                            mi2 = int(rows[j]) if j >= 0 else -1
                            j = first_min(d2, ~same, 25.0)
                            mi3 = int(rows[j]) if j >= 0 else -1
                        surf_i1[i], surf_i2[i], surf_i3[i] = ci, mi2, mi3

                    if surf_i2[i] >= 0 and surf_i3[i] >= 0:
                        t1 = self.last_surf[surf_i1[i]][:3]
                        t2 = self.last_surf[surf_i2[i]][:3]
                        t3 = self.last_surf[surf_i3[i]][:3]
                        normal = np.cross(t2 - t1, t3 - t1)
                        ps = float(np.linalg.norm(normal))
                        if ps == 0:
                            continue
                        normal = normal / ps
                        pd2 = float(normal @ psel - normal @ t1)
                        s = 1.0
                        if it >= 5:
                            s = 1 - 1.8 * abs(pd2) / math.sqrt(
                                math.sqrt(float(psel @ psel)))
                        if s > 0.1 and pd2 != 0:
                            ori_rows.append(flat[i])
                            coeff_rows.append(
                                np.concatenate([s * normal, [s * pd2]]))

                if len(ori_rows) < p.odo_min_selected:
                    continue

                mat_a = np.zeros((len(ori_rows), 6))
                mat_b = np.zeros(len(ori_rows))
                srx, crx = math.sin(self.transform[0]), math.cos(self.transform[0])
                sry, cry = math.sin(self.transform[1]), math.cos(self.transform[1])
                srz, crz = math.sin(self.transform[2]), math.cos(self.transform[2])
                tx, ty, tz = self.transform[3:]
                for r, (po, cf) in enumerate(zip(ori_rows, coeff_rows)):
                    x, y, z = po[:3]
                    cx, cy, cz = cf[:3]
                    arx = ((-crx * sry * srz * x + crx * crz * sry * y + srx * sry * z
                            + tx * crx * sry * srz - ty * crx * crz * sry - tz * srx * sry) * cx
                           + (srx * srz * x - crz * srx * y + crx * z
                              + ty * crz * srx - tz * crx - tx * srx * srz) * cy
                           + (crx * cry * srz * x - crx * cry * crz * y - cry * srx * z
                              + tz * cry * srx + ty * crx * cry * crz - tx * crx * cry * srz) * cz)
                    ary = (((-crz * sry - cry * srx * srz) * x
                            + (cry * crz * srx - sry * srz) * y - crx * cry * z
                            + tx * (crz * sry + cry * srx * srz)
                            + ty * (sry * srz - cry * crz * srx)
                            + tz * crx * cry) * cx
                           + ((cry * crz - srx * sry * srz) * x
                              + (cry * srz + crz * srx * sry) * y - crx * sry * z
                              + tz * crx * sry - ty * (cry * srz + crz * srx * sry)
                              - tx * (cry * crz - srx * sry * srz)) * cz)
                    arz = (((-cry * srz - crz * srx * sry) * x
                            + (cry * crz - srx * sry * srz) * y
                            + tx * (cry * srz + crz * srx * sry)
                            - ty * (cry * crz - srx * sry * srz)) * cx
                           + (-crx * crz * x - crx * srz * y
                              + ty * crx * srz + tx * crx * crz) * cy
                           + ((cry * crz * srx - sry * srz) * x
                              + (crz * sry + cry * srx * srz) * y
                              + tx * (sry * srz - cry * crz * srx)
                              - ty * (crz * sry + cry * srx * srz)) * cz)
                    atx = (-(cry * crz - srx * sry * srz) * cx + crx * srz * cy
                           - (crz * sry + cry * srx * srz) * cz)
                    aty = (-(cry * srz + crz * srx * sry) * cx - crx * crz * cy
                           - (sry * srz - cry * crz * srx) * cz)
                    atz = crx * sry * cx - srx * cy - crx * cry * cz
                    mat_a[r] = (arx, ary, arz, atx, aty, atz)
                    mat_b[r] = -0.05 * cf[3]

                ata = mat_a.T @ mat_a
                atb = mat_a.T @ mat_b
                x_sol = np.linalg.solve(ata, atb)

                if it == 0:
                    mat_p, is_degenerate = degeneracy_projector(
                        ata, p.odo_degeneracy)

                if is_degenerate:
                    x_sol = mat_p @ x_sol

                self.transform += x_sol
                self.transform[~np.isfinite(self.transform)] = 0.0

                delta_r = math.sqrt(float(np.sum(np.degrees(x_sol[:3]) ** 2)))
                delta_t = math.sqrt(float(np.sum((x_sol[3:] * 100) ** 2)))
                if delta_r < p.odo_delta_r_abort and delta_t < p.odo_delta_t_abort:
                    break

        # accumulate (:626-649) with the IMU shift + rotation plugin
        rot = accumulate_rotation(
            self.transform_sum[:3],
            np.array([-self.transform[0], -self.transform[1] * 1.05,
                      -self.transform[2]]))
        v = np.array([self.transform[3] - self.imu.shift_from_start[0],
                      self.transform[4] - self.imu.shift_from_start[1],
                      self.transform[5] * 1.05 - self.imu.shift_from_start[2]])
        trans = self.transform_sum[3:] - rot_zxy(*rot) @ v
        rot = plugin_imu_rotation(rot, self.imu.start_pyr, self.imu.end_pyr)
        self.transform_sum = np.concatenate([rot, trans])

        self.last_corner = self._to_end(less_sharp)
        self.last_surf = self._to_end(less_flat)
        return self.transform_sum.copy()


# ---------------------------------------------------------------------------
# Mapping: BasicLaserMapping (:103-923)
# ---------------------------------------------------------------------------

class OracleMapping:
    def __init__(self, p: OracleParams):
        self.p = p
        n = p.grid_w * p.grid_h * p.grid_d
        self.corner_cubes = [np.zeros((0, 4)) for _ in range(n)]
        self.surf_cubes = [np.zeros((0, 4)) for _ in range(n)]
        self.cen = [p.cen_w, p.cen_h, p.cen_d]
        self.tobe = np.zeros(6)
        self.aft = np.zeros(6)
        self.bef = np.zeros(6)
        # LaserMapping's own IMU subscription: (stamp, roll, pitch)
        # history for the transformUpdate blend (:171-203)
        self.imu_stamps: list = []
        self.imu_roll: list = []
        self.imu_pitch: list = []

    def push_imu(self, stamp, roll, pitch):
        self.imu_stamps.append(float(stamp))
        self.imu_roll.append(float(roll))
        self.imu_pitch.append(float(pitch))

    def _transform_update_imu(self, odom_time):
        """The 0.998/0.002 roll/pitch blend at laserOdometryTime +
        scanPeriod (BasicLaserMapping::transformUpdate, :171-203)."""
        if not self.imu_stamps:
            return
        p = self.p
        idx, n = 0, len(self.imu_stamps)
        while idx < n - 1 and \
                (odom_time - self.imu_stamps[idx]) + p.scan_period > 0:
            idx += 1
        if idx == 0 or (odom_time - self.imu_stamps[idx]) + p.scan_period > 0:
            roll, pitch = self.imu_roll[idx], self.imu_pitch[idx]
        else:
            ratio = ((self.imu_stamps[idx] - odom_time) - p.scan_period) \
                / (self.imu_stamps[idx] - self.imu_stamps[idx - 1])
            inv = 1 - ratio
            roll = self.imu_roll[idx] * inv + self.imu_roll[idx - 1] * ratio
            pitch = self.imu_pitch[idx] * inv + self.imu_pitch[idx - 1] * ratio
        self.tobe[0] = 0.998 * self.tobe[0] + 0.002 * pitch
        self.tobe[2] = 0.998 * self.tobe[2] + 0.002 * roll

    def _to_index(self, i, j, k):
        return i + self.p.grid_w * j + self.p.grid_w * self.p.grid_h * k

    def _assoc_to_map(self, pts):
        r = rot_zxy(self.tobe[0], self.tobe[1], self.tobe[2])
        out = pts.copy()
        out[:, :3] = pts[:, :3] @ r.T + self.tobe[3:]
        return out

    def _assoc_tobe(self, pts):
        rinv = (rot_z_mat(-self.tobe[2]) @ rot_x_mat(-self.tobe[0])
                @ rot_y_mat(-self.tobe[1]))
        out = pts.copy()
        out[:, :3] = (pts[:, :3] - self.tobe[3:]) @ rinv.T
        return out

    def _shift(self, axis, direction):
        """One cube-grid shift along axis (the reference's swap loops,
        :311-441). direction=+1 means the center index was too small."""
        p = self.p
        dims = [p.grid_w, p.grid_h, p.grid_d]
        for a in range(dims[(axis + 1) % 3]):
            for b in range(dims[(axis + 2) % 3]):
                coords = [0, 0, 0]
                coords[(axis + 1) % 3] = a
                coords[(axis + 2) % 3] = b
                line_c, line_s = [], []
                for c in range(dims[axis]):
                    coords[axis] = c
                    idx = self._to_index(*coords)
                    line_c.append(self.corner_cubes[idx])
                    line_s.append(self.surf_cubes[idx])
                if direction > 0:   # rotate toward higher index, clear 0
                    line_c = [np.zeros((0, 4))] + line_c[:-1]
                    line_s = [np.zeros((0, 4))] + line_s[:-1]
                else:               # rotate toward lower index, clear last
                    line_c = line_c[1:] + [np.zeros((0, 4))]
                    line_s = line_s[1:] + [np.zeros((0, 4))]
                for c in range(dims[axis]):
                    coords[axis] = c
                    idx = self._to_index(*coords)
                    self.corner_cubes[idx] = line_c[c]
                    self.surf_cubes[idx] = line_s[c]

    def process(self, corner_last, surf_last, transform_sum,
                odom_time: float | None = None):
        p = self.p
        self.tobe = transform_associate_to_map(transform_sum, self.bef,
                                               self.aft)

        corner_stack = self._assoc_to_map(corner_last)
        surf_stack = self._assoc_to_map(surf_last)

        y_axis_pt = (rot_zxy(*self.tobe[:3]) @ np.array([0.0, 10.0, 0.0])
                     + self.tobe[3:])

        CUBE = p.cube_size
        HALF = CUBE / 2

        def cube_coord(pos):
            ci = int((pos[0] + HALF) / CUBE) + self.cen[0]
            cj = int((pos[1] + HALF) / CUBE) + self.cen[1]
            ck = int((pos[2] + HALF) / CUBE) + self.cen[2]
            if pos[0] + HALF < 0:
                ci -= 1
            if pos[1] + HALF < 0:
                cj -= 1
            if pos[2] + HALF < 0:
                ck -= 1
            return ci, cj, ck

        ci, cj, ck = cube_coord(self.tobe[3:])
        dims = [p.grid_w, p.grid_h, p.grid_d]
        center = [ci, cj, ck]
        for axis in range(3):
            while center[axis] < p.recenter_margin:
                self._shift(axis, +1)
                center[axis] += 1
                self.cen[axis] += 1
            while center[axis] >= dims[axis] - p.recenter_margin:
                self._shift(axis, -1)
                center[axis] -= 1
                self.cen[axis] -= 1
        ci, cj, ck = center

        valid_ind, surround_ind = [], []
        nb = p.neighborhood
        for i in range(ci - nb, ci + nb + 1):
            for j in range(cj - nb, cj + nb + 1):
                for k in range(ck - nb, ck + nb + 1):
                    if not (0 <= i < p.grid_w and 0 <= j < p.grid_h
                            and 0 <= k < p.grid_d):
                        continue
                    cx = CUBE * (i - self.cen[0])
                    cy = CUBE * (j - self.cen[1])
                    cz = CUBE * (k - self.cen[2])
                    in_fov = False
                    for ii in (-1, 1):
                        for jj in (-1, 1):
                            for kk in (-1, 1):
                                corner = np.array([cx + HALF * ii,
                                                   cy + HALF * jj,
                                                   cz + HALF * kk])
                                sq1 = float(np.sum(
                                    (self.tobe[3:] - corner) ** 2))
                                sq2 = float(np.sum(
                                    (y_axis_pt - corner) ** 2))
                                term = 10.0 * math.sqrt(3.0) * math.sqrt(sq1)
                                if (100.0 + sq1 - sq2 - term < 0
                                        and 100.0 + sq1 - sq2 + term > 0):
                                    in_fov = True
                    idx = self._to_index(i, j, k)
                    if in_fov:
                        valid_ind.append(idx)
                    surround_ind.append(idx)

        map_corner = (np.concatenate([self.corner_cubes[i]
                                      for i in valid_ind])
                      if valid_ind else np.zeros((0, 4)))
        map_surf = (np.concatenate([self.surf_cubes[i] for i in valid_ind])
                    if valid_ind else np.zeros((0, 4)))

        corner_stack = self._assoc_tobe(corner_stack)
        surf_stack = self._assoc_tobe(surf_stack)
        corner_stack = voxel_grid(corner_stack, p.corner_leaf) \
            if len(corner_stack) else corner_stack
        surf_stack = voxel_grid(surf_stack, p.surf_leaf) \
            if len(surf_stack) else surf_stack

        self._optimize(corner_stack, surf_stack, map_corner, map_surf)

        # transformUpdate (:171-203): IMU roll/pitch blend, then latch
        if odom_time is not None:
            self._transform_update_imu(odom_time)
        self.bef = transform_sum.copy()
        self.aft = self.tobe.copy()

        # scatter stacks into cubes (:536-577)
        for stack, cubes in ((corner_stack, self.corner_cubes),
                             (surf_stack, self.surf_cubes)):
            if not len(stack):
                continue
            mapped = self._assoc_to_map(stack)
            for row in mapped:
                i, j, k = cube_coord(row[:3])
                if 0 <= i < p.grid_w and 0 <= j < p.grid_h \
                        and 0 <= k < p.grid_d:
                    idx = self._to_index(i, j, k)
                    cubes[idx] = np.concatenate([cubes[idx], row[None]])

        # re-downsample valid cubes (:580-593)
        for idx in valid_ind:
            if len(self.corner_cubes[idx]):
                self.corner_cubes[idx] = voxel_grid(self.corner_cubes[idx],
                                                    p.corner_leaf)
            if len(self.surf_cubes[idx]):
                self.surf_cubes[idx] = voxel_grid(self.surf_cubes[idx],
                                                  p.surf_leaf)
        return self.aft.copy(), self.bef.copy()

    def _optimize(self, corner_stack, surf_stack, map_corner, map_surf):
        p = self.p
        if (len(map_corner) <= p.map_min_corner
                or len(map_surf) <= p.map_min_surf):
            return
        is_degenerate = False
        mat_p = np.eye(6)
        for it in range(p.map_max_iterations):
            ori_rows, coeff_rows = [], []

            for i in range(len(corner_stack)):
                po = corner_stack[i]
                psel = (rot_zxy(*self.tobe[:3]) @ po[:3]) + self.tobe[3:]
                nn_idx, nn_d2 = knn(psel, map_corner, 5)
                if len(nn_d2) == 5 and nn_d2[4] < 1.0:
                    nbrs = map_corner[nn_idx][:, :3]
                    vc = nbrs.mean(axis=0)
                    a = nbrs - vc
                    cov = (a.T @ a) / 5.0
                    w, v = np.linalg.eigh(cov)
                    if w[2] > 3 * w[1]:
                        unit = v[:, 2]
                        pa = vc + 0.1 * unit
                        pb = vc - 0.1 * unit
                        cvec = np.cross(psel - pa, psel - pb)
                        a012 = float(np.linalg.norm(cvec))
                        l12 = float(np.linalg.norm(pa - pb))
                        if a012 == 0 or l12 == 0:
                            continue
                        ld2 = a012 / l12
                        direction = np.cross(pa - pb, cvec / a012) / l12
                        s = 1 - 0.9 * abs(ld2)
                        if s > 0.1:
                            ori_rows.append(po)
                            coeff_rows.append(
                                np.concatenate([s * direction, [s * ld2]]))

            for i in range(len(surf_stack)):
                po = surf_stack[i]
                psel = (rot_zxy(*self.tobe[:3]) @ po[:3]) + self.tobe[3:]
                nn_idx, nn_d2 = knn(psel, map_surf, 5)
                if len(nn_d2) == 5 and nn_d2[4] < 1.0:
                    nbrs = map_surf[nn_idx][:, :3]
                    sol, *_ = np.linalg.lstsq(nbrs, -np.ones(5), rcond=None)
                    ps = float(np.linalg.norm(sol))
                    if ps == 0:
                        continue
                    normal = sol / ps
                    pd = 1.0 / ps
                    if np.any(np.abs(nbrs @ normal + pd) > 0.2):
                        continue
                    pd2 = float(normal @ psel + pd)
                    s = 1 - 0.9 * abs(pd2) / math.sqrt(
                        math.sqrt(float(psel @ psel)))
                    if s > 0.1:
                        ori_rows.append(po)
                        coeff_rows.append(
                            np.concatenate([s * normal, [s * pd2]]))

            if len(ori_rows) < p.map_min_selected:
                continue

            srx, crx = math.sin(self.tobe[0]), math.cos(self.tobe[0])
            sry, cry = math.sin(self.tobe[1]), math.cos(self.tobe[1])
            srz, crz = math.sin(self.tobe[2]), math.cos(self.tobe[2])
            mat_a = np.zeros((len(ori_rows), 6))
            mat_b = np.zeros(len(ori_rows))
            for r, (po, cf) in enumerate(zip(ori_rows, coeff_rows)):
                x, y, z = po[:3]
                cx, cy, cz = cf[:3]
                arx = ((crx * sry * srz * x + crx * crz * sry * y - srx * sry * z) * cx
                       + (-srx * srz * x - crz * srx * y - crx * z) * cy
                       + (crx * cry * srz * x + crx * cry * crz * y - cry * srx * z) * cz)
                ary = (((cry * srx * srz - crz * sry) * x
                        + (sry * srz + cry * crz * srx) * y + crx * cry * z) * cx
                       + ((-cry * crz - srx * sry * srz) * x
                          + (cry * srz - crz * srx * sry) * y - crx * sry * z) * cz)
                arz = (((crz * srx * sry - cry * srz) * x
                        + (-cry * crz - srx * sry * srz) * y) * cx
                       + (crx * crz * x - crx * srz * y) * cy
                       + ((sry * srz + cry * crz * srx) * x
                          + (crz * sry - cry * srx * srz) * y) * cz)
                mat_a[r] = (arx, ary, arz, cx, cy, cz)
                mat_b[r] = -cf[3]

            ata = mat_a.T @ mat_a
            atb = mat_a.T @ mat_b
            x_sol = np.linalg.solve(ata, atb)

            if it == 0:
                mat_p, is_degenerate = degeneracy_projector(
                    ata, p.map_degeneracy)
            if is_degenerate:
                x_sol = mat_p @ x_sol

            self.tobe += x_sol
            delta_r = math.sqrt(float(np.sum(np.degrees(x_sol[:3]) ** 2)))
            delta_t = math.sqrt(float(np.sum((x_sol[3:] * 100) ** 2)))
            if delta_r < p.map_delta_abort and delta_t < p.map_delta_abort:
                break


# ---------------------------------------------------------------------------
# Full pipeline driver (the 4-node launch topology, sequentialized)
# ---------------------------------------------------------------------------

class OraclePipeline:
    """Feeds each sweep through registration -> odometry -> (ioRatio-
    gated) mapping -> maintenance, like launch/loam_velodyne.launch with
    deterministic in-order message delivery."""

    def __init__(self, params: OracleParams | None = None,
                 imu: OracleImu | None = None):
        self.p = params or OracleParams()
        self.odo = OracleOdometry(self.p)
        self.mapping = OracleMapping(self.p)
        self.imu = imu
        self.sweep = 0

    def push_imu(self, stamp, rpy, acc_swapped):
        """Feed one IMU sample to both subscribers (registration's full
        state history and mapping's roll/pitch history), like the
        /imu/data fan-out in the hector launch."""
        if self.imu is None:
            self.imu = OracleImu()
        self.imu.push(stamp, rpy, acc_swapped)
        self.mapping.push_imu(stamp, rpy[0], rpy[1])

    def process_sweep(self, pts, stamp: float = 0.0):
        p = self.p
        rings, imu_trans = ingest(np.asarray(pts, np.float64), p,
                                  imu=self.imu, scan_time=stamp)
        sharp, less_sharp, flat, less_flat = extract_features(rings, p)
        odom = self.odo.process(sharp, less_sharp, flat, less_flat,
                                imu_trans)

        # LaserOdometry forwards clouds every ioRatio frames
        # (LaserOdometry.cpp:320), never on the init frame.
        if self.sweep % p.io_ratio == 1:
            self.mapping.process(self.odo.last_corner, self.odo.last_surf,
                                 odom, odom_time=stamp)
        fused = transform_associate_to_map(odom, self.mapping.bef,
                                           self.mapping.aft)
        self.sweep += 1
        return {"odom": odom, "aft": self.mapping.aft.copy(),
                "fused": fused,
                "shed": shed(rings, (sharp, less_sharp, flat, less_flat), p)}


def shed(rings, features, p: OracleParams):
    """The rows a sweep's ingest and feature clouds would shed under the
    configuration's fixed capacities: (points past a ring's
    ``max_points_per_ring``, feature rows past the sharp / less-sharp /
    flat / less-flat capacities). The C++ keeps every row; the port's
    configurations state these capacities and count every row they shed."""
    cap = getattr(p, "points_per_ring", None)
    caps = getattr(p, "caps", None)
    if cap is None or caps is None:
        return (0, 0)
    ingest_shed = sum(max(0, len(r) - cap) for r in rings)
    names = ("sharp", "less_sharp", "flat", "less_flat")
    feature_shed = sum(max(0, len(f) - caps[n])
                       for f, n in zip(features, names))
    return (ingest_shed, feature_shed)


def follow(loam: dict, sweeps) -> dict:
    """A fresh pipeline of the configuration ``loam`` over ``sweeps`` (a
    list of (N_i, 3) sensor-frame points, 0.1 s apart): each sweep's
    poses (odometry, mapped, fused; (n, 18)) and sheds ((n, 2))."""
    p = OracleParams.of(loam)
    pipe = OraclePipeline(p)
    poses, sheds = [], []
    for k, pts in enumerate(sweeps):
        r = pipe.process_sweep(pts, k * p.scan_period)
        poses.append(np.concatenate([r["odom"], r["aft"], r["fused"]]))
        sheds.append(r["shed"])
    return {"poses": np.array(poses).reshape(-1, 18),
            "shed": np.array(sheds, np.int64).reshape(-1, 2)}
