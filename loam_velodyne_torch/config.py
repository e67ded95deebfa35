"""Typed configuration of the PyTorch port.

Field for field the same dataclasses, defaults and presets as
``loam_velodyne_tpu/config.py`` (tests/test_torch_config.py pins the
two together), kept in this package so that the port stands alone
where the JAX package is not installed. The defaults reproduce the
reference (laboshinl/loam_velodyne) launch defaults:

- registration params: reference BasicScanRegistration.h:34-72 and
  BasicScanRegistration.cpp:9-26
- odometry params:     reference BasicLaserOdometry.cpp:20-26, LaserOdometry.h:59
- mapping params:      reference BasicLaserMapping.cpp:51-100
- lidar ring tables:   reference MultiScanRegistration.h:83-89

The whole engine is configured from one frozen dataclass; every shape
of the step is a static function of it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"invalid configuration: {msg}")


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Vertical ring geometry of a multi-ring spinning lidar:
    ring id = round((vertical_angle_deg - lower_bound) * factor)
    (reference MultiScanRegistration.cpp:41-66)."""

    name: str
    lower_bound_deg: float
    upper_bound_deg: float
    n_rings: int
    # Max points per ring after binning (fixed capacity; excess dropped).
    max_points_per_ring: int = 2048

    @property
    def factor(self) -> float:
        return (self.n_rings - 1) / (self.upper_bound_deg - self.lower_bound_deg)


# Presets per the Velodyne data sheets (reference MultiScanRegistration.h:83-89).
VLP16 = LidarConfig("VLP-16", -15.0, 15.0, 16, max_points_per_ring=2048)
HDL32 = LidarConfig("HDL-32", -30.67, 10.67, 32, max_points_per_ring=2304)
HDL64E = LidarConfig("HDL-64E", -24.9, 2.0, 64, max_points_per_ring=2304)

LIDAR_PRESETS = {c.name: c for c in (VLP16, HDL32, HDL64E)}


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Feature-extraction parameters (reference BasicScanRegistration.h:34-72)."""

    scan_period: float = 0.1          # seconds per sweep
    imu_history_size: int = 200       # IMU ring buffer capacity
    n_feature_regions: int = 6        # regions per ring
    curvature_region: int = 5         # +/- neighborhood for curvature
    max_corner_sharp: int = 2         # sharp corners per region
    max_surface_flat: int = 4         # flat points per region
    less_flat_filter_size: float = 0.2   # voxel leaf for less-flat downsample
    surface_curvature_threshold: float = 0.1
    system_delay: int = 20            # sweeps dropped at startup (MultiScanRegistration.h:133)
    # Greedy pick steps per (ring, region) row: the top candidates by
    # curvature; they cover the quotas (20 corners / 4 flats).
    corner_scan_cap: int = 96
    flat_scan_cap: int = 64
    min_sq_range: float = 1e-4        # zero-point filter (MultiScanRegistration.cpp:194)

    def __post_init__(self):
        _require(self.scan_period > 0, "scan_period must be positive")
        _require(self.imu_history_size >= 1, "imu_history_size must be >= 1")
        _require(self.n_feature_regions >= 1,
                 "n_feature_regions must be >= 1")
        _require(self.curvature_region >= 1, "curvature_region must be >= 1")
        _require(self.max_corner_sharp >= 1, "max_corner_sharp must be >= 1")
        _require(self.max_surface_flat >= 1, "max_surface_flat must be >= 1")
        _require(self.less_flat_filter_size > 0,
                 "less_flat_filter_size must be positive")
        _require(self.surface_curvature_threshold > 0,
                 "surface_curvature_threshold must be positive")
        _require(self.corner_scan_cap >= self.max_corner_less_sharp,
                 "corner_scan_cap must cover the less-sharp quota")
        _require(self.flat_scan_cap >= self.max_surface_flat,
                 "flat_scan_cap must cover the flat quota")

    @property
    def max_corner_less_sharp(self) -> int:
        # reference BasicScanRegistration.cpp:22
        return 10 * self.max_corner_sharp


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan alignment parameters (reference BasicLaserOdometry.cpp:20-36)."""

    max_iterations: int = 25
    delta_t_abort: float = 0.1        # cm-scale translation abort
    delta_r_abort: float = 0.1        # degree-scale rotation abort
    corresp_refresh_every: int = 5    # re-find correspondences every N iters
    # Robust weighting starts at this iteration (reference
    # BasicLaserOdometry.cpp:345; distinct from the refresh cadence, :251).
    weight_start_iteration: int = 5
    nn_sq_dist_gate: float = 25.0     # 1-NN acceptance gate (m^2)
    ring_bracket: float = 2.5         # +/- rings for secondary line/plane points
    weight_decay: float = 1.8         # robust weight s = 1 - 1.8*|d| after iter 5
    weight_floor: float = 0.1         # drop residuals with s <= 0.1
    residual_scale: float = 0.05      # matB = -0.05*d (BasicLaserOdometry.cpp:553)
    degeneracy_eigen_threshold: float = 10.0
    min_corner_points: int = 10       # skip solve below these cloud sizes
    min_surface_points: int = 100
    min_selected: int = 10            # skip iteration if fewer residuals
    io_ratio: int = 2                 # publish clouds to mapping every Nth frame
    rot_y_fudge: float = 1.05         # drift compensation (BasicLaserOdometry.cpp:631)
    pos_z_fudge: float = 1.05         # drift compensation (BasicLaserOdometry.cpp:637)


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map parameters (reference BasicLaserMapping.cpp:51-100)."""

    max_iterations: int = 10
    delta_t_abort: float = 0.05
    delta_r_abort: float = 0.05
    # 5-NN + fit refresh cadence inside the GN loop (the reference
    # re-searches every iteration; 1 gives its exact behavior).
    corresp_refresh_every: int = 2
    cube_size: float = 50.0           # meters per map cube
    grid_width: int = 21              # cubes along x
    grid_height: int = 11             # cubes along y
    grid_depth: int = 21              # cubes along z
    center_width: int = 10            # initial center cube index
    center_height: int = 5
    center_depth: int = 10
    recenter_margin: int = 3          # keep sensor >= 3 cubes from grid edge
    neighborhood: int = 2             # +/- cubes searched around center (5x5x5)
    corner_leaf: float = 0.2          # voxel leaf sizes (BasicLaserMapping.cpp:98-99)
    surf_leaf: float = 0.4
    stack_frame_num: int = 1
    map_frame_num: int = 5            # surround map publish cadence
    nn_sq_dist_gate: float = 1.0      # 5th-NN gate (m^2)
    line_eigen_ratio: float = 3.0     # corner validity lambda2 > 3*lambda1
    line_half_length: float = 0.1     # +/- offset along edge direction
    plane_max_residual: float = 0.2   # plane validity gate
    corner_weight_decay: float = 0.9  # s = 1 - 0.9*|d|
    weight_floor: float = 0.1
    degeneracy_eigen_threshold: float = 100.0
    imu_blend: float = 0.002          # roll/pitch IMU blend (BasicLaserMapping.cpp:197-198)
    min_corner_map_points: int = 10
    min_surface_map_points: int = 100
    min_selected: int = 50
    # Per-cube SEARCH-slab capacities: post-thin rows past capacity
    # spill evenly into the lossless archive pool.
    corner_cube_capacity: int = 512
    surf_cube_capacity: int = 768
    # Insert headroom of the working slabs; only the post-thin result is
    # clipped back to capacity.
    insert_headroom: int = 256
    # Per-frame budget for points beyond the +-neighborhood cubes.
    far_insert_budget: int = 256
    # Archive pool: the overflow tier that keeps the map lossless
    # (reference push_back keeps everything, BasicLaserMapping.cpp:536-577).
    archive_capacity: int = 262144
    archive_cubes_per_frame: int = 8     # top over-capacity cubes spilled
    archive_append_budget: int = 2048    # rows archived per frame per kind
    # Archive rows offered back to the search slabs per mapping frame,
    # starting at the first row whose cube is in the search neighborhood.
    archive_reinstate_budget: int = 256
    fov_half_aperture_term: float = 100.0  # FOV check constant (BasicLaserMapping.cpp:477-481)
    # Downsampled feature-stack capacities (inputs to the map GN).
    corner_stack_capacity: int = 2048
    surf_stack_capacity: int = 4096
    # Of the 125 neighborhood cubes, at most this many are assembled
    # per frame.
    max_active_cubes: int = 64
    # At most this many cubes that received inserts are re-thinned per
    # mapping frame.
    thin_active_cubes: int = 32
    # Candidate window + query-group size of the axis-sorted tiled 5-NN
    # search (ops/neighbors.py::tiled_windowed_knn).
    knn_window: int = 1024
    knn_group: int = 128

    def __post_init__(self):
        _require(self.max_iterations >= 1, "max_iterations must be >= 1")
        _require(self.cube_size > 0, "cube_size must be positive")
        for name in ("grid_width", "grid_height", "grid_depth"):
            dim = getattr(self, name)
            _require(dim >= 2 * self.neighborhood + 1,
                     f"{name} must be >= the search neighborhood"
                     f" ({2 * self.neighborhood + 1})")
            _require(dim > 2 * self.recenter_margin,
                     f"{name} must exceed 2*recenter_margin")
        _require(self.corner_leaf > 0 and self.surf_leaf > 0,
                 "voxel leaf sizes must be positive")
        _require(self.knn_window >= 8, "knn_window must be >= 8")
        _require(self.archive_capacity >= self.archive_reinstate_budget,
                 "archive_capacity must cover archive_reinstate_budget")

    @property
    def n_cubes(self) -> int:
        return self.grid_width * self.grid_height * self.grid_depth

    @property
    def n_neighborhood_cubes(self) -> int:
        side = 2 * self.neighborhood + 1
        return side * side * side


@dataclasses.dataclass(frozen=True)
class Capacities:
    """Fixed array capacities of the feature clouds (padded arrays with a
    validity mask where the reference has dynamically sized clouds)."""

    sharp: int = 256          # sharp corners per sweep
    less_sharp: int = 2048    # less-sharp corners per sweep
    flat: int = 512           # flat surface points per sweep
    less_flat: int = 8192     # downsampled less-flat points per sweep
    full_cloud: int = 40960   # full-resolution reprojected sweep

    @staticmethod
    def for_lidar(lidar: LidarConfig, reg: RegistrationConfig,
                  mapping: MappingConfig) -> "Capacities":
        r, n = lidar.n_rings, reg.n_feature_regions
        sharp = _round_up(r * n * reg.max_corner_sharp, 128)
        less_sharp = _round_up(r * n * reg.max_corner_less_sharp, 128)
        flat = _round_up(r * n * reg.max_surface_flat, 128)
        # 64-ring sensors occupy ~14k cells per sweep at the 0.2 m leaf.
        less_flat = _round_up(min(r * 512, 8192 if r <= 32 else 16384), 128)
        full = _round_up(r * lidar.max_points_per_ring, 128)
        return Capacities(
            sharp=sharp, less_sharp=less_sharp, flat=flat,
            less_flat=less_flat, full_cloud=full,
        )


@dataclasses.dataclass(frozen=True)
class LoamConfig:
    """Top-level engine configuration."""

    lidar: LidarConfig = VLP16
    registration: RegistrationConfig = RegistrationConfig()
    odometry: OdometryConfig = OdometryConfig()
    mapping: MappingConfig = MappingConfig()
    capacities: Optional[Capacities] = None

    def __post_init__(self):
        if self.capacities is None:
            object.__setattr__(
                self, "capacities",
                Capacities.for_lidar(self.lidar, self.registration, self.mapping))

    @staticmethod
    def preset(lidar_name: str = "VLP-16", **overrides) -> "LoamConfig":
        lidar = LIDAR_PRESETS[lidar_name]
        return LoamConfig(lidar=lidar, **overrides)

    def sized_for_stream(self, max_sweep_points: int,
                         margin: float = 1.25) -> "LoamConfig":
        """Bucket the ring capacity to the OBSERVED stream density.

        The datasheet presets size ``max_points_per_ring`` for the
        sensor's maximum firing rate (e.g. HDL-64E at ~2.3k points/ring/
        rev), but every fixed-shape pass — the ingest ring sort, the
        (R, P) feature grid, the class-ordered compaction sort — costs
        O(R * P) regardless of how many rows are real. A capture denser
        than its stream needs pays that padding on every sweep: the
        reference's dynamically-sized pcl clouds only ever process real
        points (laserCloudIn.size() loops, MultiScanRegistration.cpp:
        158-234), so capacity-vs-stream mismatch is pure overhead the
        reference never has. This picks the 128-aligned (Pallas lane
        tile) bucket covering ``max_sweep_points / n_rings`` with a
        margin for ring unevenness, capped at the datasheet preset, and
        recomputes the derived capacities. Ring overflow past the bucket
        is counted by the ``ingest_dropped`` telemetry — a consumer
        seeing drops should re-run with a bigger margin.
        """
        import math
        per_ring = math.ceil(max_sweep_points / self.lidar.n_rings * margin)
        p = min(self.lidar.max_points_per_ring,
                max(_round_up(per_ring, 128), 128))
        lidar = dataclasses.replace(self.lidar, max_points_per_ring=p)
        return dataclasses.replace(self, lidar=lidar, capacities=None)

    @staticmethod
    def from_dict(d: dict) -> "LoamConfig":
        """The configuration whose fields are the nested dict ``d``
        (``dataclasses.asdict`` of this class or of an equal one)."""
        return LoamConfig(
            lidar=LidarConfig(**d["lidar"]),
            registration=RegistrationConfig(**d["registration"]),
            odometry=OdometryConfig(**d["odometry"]),
            mapping=MappingConfig(**d["mapping"]),
            capacities=Capacities(**d["capacities"]))


def stream_cap(sweeps) -> int:
    """128-aligned input padding covering the stream's densest sweep
    (``bench.py::stream_cap``): the sweep capacity N to pair with
    ``LoamConfig.sized_for_stream``. N drives the ingest ring sort and
    the ring histogram, O(N) per sweep whether rows are real or
    padding."""
    return max(128, _round_up(max(len(s) for s in sweeps), 128))


def apply_overrides(cfg, overrides):
    """Apply dotted-path overrides to the frozen config tree."""
    for item in overrides or []:
        path, _, raw = item.partition("=")
        if not _:
            raise SystemExit(f"--set expects key=value, got {item!r}")
        keys = path.split(".")
        targets = [cfg]
        for k in keys[:-1]:
            targets.append(getattr(targets[-1], k))
        field_types = {f.name: f.type for f in dataclasses.fields(targets[-1])}
        if keys[-1] not in field_types:
            raise SystemExit(f"unknown config field {path!r}")
        old = getattr(targets[-1], keys[-1])
        value = type(old)(json.loads(raw)) if not isinstance(old, str) else raw
        obj = dataclasses.replace(targets[-1], **{keys[-1]: value})
        for parent, k in zip(reversed(targets[:-1]), reversed(keys[:-1])):
            obj = dataclasses.replace(parent, **{k: obj})
        cfg = obj
    return cfg
