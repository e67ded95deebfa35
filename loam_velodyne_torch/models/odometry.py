"""Scan-to-scan odometry: 6-DoF motion at sweep rate.

Counterpart of ``loam_velodyne_tpu/models/odometry.py``, with both of
its Gauss-Newton schedules. The static one (``run_gn_static``, the
chunked replay's and the per-sweep graphs'): correspondences are
re-found at the start of each refresh phase through kernel K3, and an
iteration that would come after the early abort is frozen by masks, so
nothing is read back from the device. Each phase, and each iteration
after a phase's first, is a region of ``models/conditional.py``: eagerly
it runs masked, and in a CUDA graph the card skips it once the GN has
stopped, as the JAX package's ``lax.while_loop`` over phases leaves at
the converged one. The dynamic one (``run_gauss_newton`` with
``static_schedule=False``, the per-sweep path's plain reference):
correspondences are re-found every ``corresp_refresh_every`` iterations
and the loop stops at the first converged iteration, which costs one
read of the stop flag per iteration. Both give the same transform. The
IMU sweep state (``ops/imu.py::sweep_state``) enters as in the JAX
package: the pitch / roll seed on the first sweep, the velocity prior,
the shift terms and ``plugin_imu_rotation``; without an IMU it is zero.

A step is three parts: ``initial_transform`` (the GN's start), the GN
(``run_gauss_newton``; in the static schedule ``gn_phases``, each a
``gn_phase``: one refresh of the correspondences and its iterations)
and ``finish`` (the pose accumulation and the clouds for the next
sweep); ``first_sweep`` is the step of a sequence's first sweep, which
has no GN.

Which branch a step takes (first sweep or not) is a host-side flag
where the engine keeps the sweep counter on the host (the single
stream); the batched step passes the state's own flag, and each lane
takes its branch on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from loam_velodyne_torch.config import LoamConfig
from loam_velodyne_torch.models import conditional
from loam_velodyne_torch.ops import launches
from loam_velodyne_torch.ops.features import SweepFeatures
from loam_velodyne_torch.ops.neighbors import (corner_correspondences_fused,
                                               surf_correspondences_fused)
from loam_velodyne_torch.types import PointSet
from loam_velodyne_torch.utils import math as lm
from loam_velodyne_torch.utils.linalg import jacobi_eigh
from loam_velodyne_torch.utils import profiling

Tensor = torch.Tensor


class ImuSweepState(NamedTuple):
    """Per-sweep IMU summary, all (3,) vectors; zeros without an IMU."""

    start_rpy: Tensor
    end_rpy: Tensor
    shift_from_start: Tensor
    velo_from_start: Tensor

    @staticmethod
    def zero(device) -> "ImuSweepState":
        z = torch.zeros((3,), dtype=torch.float32, device=device)
        return ImuSweepState(z, z, z, z)


class OdometryState(NamedTuple):
    last_corner: PointSet    # previous sweep's less-sharp corners (end frame)
    last_surf: PointSet      # previous sweep's less-flat surfels (end frame)
    transform: Tensor        # (6,) current sweep motion estimate
    transform_sum: Tensor    # (6,) accumulated global pose
    initialized: Tensor      # () bool
    frame: Tensor            # () int32

    @staticmethod
    def create(cfg: LoamConfig, device) -> "OdometryState":
        caps = cfg.capacities
        return OdometryState(
            last_corner=PointSet.empty(caps.less_sharp, device),
            last_surf=PointSet.empty(caps.less_flat, device),
            transform=lm.identity_pose(device),
            transform_sum=lm.identity_pose(device),
            initialized=torch.zeros((), dtype=torch.bool, device=device),
            frame=torch.zeros((), dtype=torch.int32, device=device))


class OdometryOutputs(NamedTuple):
    transform_sum: Tensor    # (6,) pose after this sweep
    corner_cloud: PointSet   # less-sharp cloud in the end frame
    surf_cloud: PointSet     # less-flat cloud in the end frame


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt((x * x).sum(-1))


def _deskew_model(tf: Tensor, pts: Tensor) -> Tensor:
    """The s=1 deskew the GN linearizes around: Ry(-ry) Rx(-rx) Rz(-rz) (p - t)."""
    m = lm.rot_zxy_mat(-tf[2], -tf[0], -tf[1])
    return lm.apply_rot(m, pts - tf[3:6])


def _line_residual(x0: Tensor, a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Point-to-line distance and its gradient direction wrt x0."""
    c = torch.linalg.cross(x0 - a, x0 - b, dim=-1)
    a012 = _norm(c)
    l12 = _norm(a - b)
    safe_a = a012.clamp(min=1e-12)
    safe_l = l12.clamp(min=1e-12)
    d = a012 / safe_l
    direction = torch.linalg.cross(a - b, c / safe_a[..., None],
                                   dim=-1) / safe_l[..., None]
    return d, direction


def _plane_residual(x0: Tensor, t1: Tensor, t2: Tensor, t3: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Signed point-to-plane distance and unit normal."""
    n = torch.linalg.cross(t2 - t1, t3 - t1, dim=-1)
    n = n / _norm(n).clamp(min=1e-12)[..., None]
    d = (n * x0).sum(-1) - (n * t1).sum(-1)
    return d, n


def _mat3_mul(a: Tensor, b: Tensor) -> Tensor:
    """(...,3,3) @ (...,3,3): ``utils/math.py::mat3_mul``'s float32
    multiply-adds in its order, each term a whole outer product (five
    operations in place of its 45)."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _grad_left(g: Tensor, b: Tensor) -> Tensor:
    """d/da of sum(g * (a @ b)) for a per-point g (...,3,3): g b^T, its
    terms summed last to first."""
    t = [g[..., :, j:j + 1] * b[:, j] for j in range(3)]
    return (t[2] + t[1]) + t[0]


def _grad_right(a: Tensor, g: Tensor) -> Tensor:
    """d/db of sum(g * (a @ b)) for a per-point g (...,3,3): a^T g, its
    terms summed last to first."""
    t = [a[i, :, None] * g[..., i:i + 1, :] for i in range(3)]
    return (t[2] + t[1]) + t[0]


def _jacobian_rows(tf: Tensor, pts: Tensor, coeff: Tensor) -> Tensor:
    """Rows of the GN design matrix: d(coeff . deskew_model(tf, p))/d(tf),
    (N, 6), in closed form: the reference's arx..atz
    (BasicLaserOdometry.cpp:497-554), written as the chain rule through
    M = Ry(-ry) (Rx(-rx) Rz(-rz)). For each point, G = coeff (p - t)^T is
    carried back to each factor R(a), and from that factor's cosine and
    sine entries (dcos, dsin) to its angle: d/dr = dcos sin a - dsin cos a
    at a = -r. The translation columns are -M^T coeff. The products and
    sums are those of reverse-mode autodiff through ``_deskew_model``, in
    its order, so the rows equal the functorch ``vmap(grad)`` rows bit for
    bit. Broadcast float32 multiplies and adds, no matmul: 56 operations
    a call, whatever the number of points."""
    ang = -tf[:3]
    s, c = torch.sin(ang), torch.cos(ang)
    o, z = torch.ones_like(s[0]), torch.zeros_like(s[0])
    sx, sy, sz = s.unbind(-1)
    cx, cy, cz = c.unbind(-1)
    nx, ny, nz = (-s).unbind(-1)
    rx, ry, rz = torch.stack([o, z, z, z, cx, nx, z, sx, cx,
                              cy, z, sy, z, o, z, ny, z, cy,
                              cz, nz, z, sz, cz, z, z, z, o],
                             -1).unflatten(-1, (3, 3, 3)).unbind(-3)
    n = _mat3_mul(rx, rz)
    m = _mat3_mul(ry, n)
    q = pts - tf[3:6]
    g = coeff[..., :, None] * q[..., None, :]            # dL/dM, (N, 3, 3)
    d_ry = _grad_left(g, n)
    d_n = _grad_right(ry, g)
    d_rx = _grad_left(d_n, rz)
    d_rz = _grad_right(rx, d_n)
    # Rows: the factors' gradients at their two cosine entries, at the
    # sine entry and at the negated sine entry; columns: x, y, z.
    e = torch.stack([d_rx[..., 2, 2], d_ry[..., 2, 2], d_rz[..., 1, 1],
                     d_rx[..., 1, 1], d_ry[..., 0, 0], d_rz[..., 0, 0],
                     d_rx[..., 2, 1], d_ry[..., 0, 2], d_rz[..., 1, 0],
                     d_rx[..., 1, 2], d_ry[..., 2, 0], d_rz[..., 0, 1]],
                    -1).unflatten(-1, (4, 3))
    rot = (e[..., 0, :] + e[..., 1, :]) * s - (e[..., 2, :] - e[..., 3, :]) * c
    t = [coeff[..., i:i + 1] * m[i] for i in range(3)]
    rows = torch.cat([rot, -((t[2] + t[1]) + t[0])], dim=-1)
    # Autodiff sums each partial into a zero gradient, so a -0 reads +0.
    return rows + 0.0


def solve_gn(a_rows: Tensor, b_vec: Tensor) -> Tuple[Tensor, Tensor]:
    """Normal-equation solve in full float32; returns (x, AtA). The
    ``_ex`` form reports a singular system in ``info`` instead of
    raising, so the solve never reads back from the device; a singular
    step is caught by the finiteness guard like the JAX package's."""
    ata = a_rows.T @ a_rows
    atb = a_rows.T @ b_vec
    x, _ = torch.linalg.solve_ex(ata, atb)
    return x, ata


def degeneracy_projector(ata: Tensor, threshold: float) -> Tuple[Tensor, Tensor]:
    """P = V diag(keep) V^T, zeroing eigendirections with eigenvalue
    below threshold; also whether any direction was dropped. The
    eigendecomposition is ``utils/linalg.py::jacobi_eigh`` on every
    device: ``torch.linalg.eigh`` reads its status back on the card,
    which would stop the static chunk from being captured. It runs in
    float64 and is rounded to float32: the eigenpairs of the float32
    matrix rounded once (on the CPU bit-equal to LAPACK's float64
    eigh), whatever the device, so the keep decisions near the
    threshold do not depend on an algorithm's float32 rounding."""
    w, v = jacobi_eigh(ata.double())
    w, v = w.float(), v.float()
    keep = (w >= threshold).to(torch.float32)
    return (v * keep[None, :]) @ v.T, (keep < 0.5).any()


def _gn_iteration(tf, it: int, mat_p0, degenerate0, x_c, x_s, sharp, flat,
                  last_corner, last_surf, cj, cl, cvalid, sj, sl, sm_, svalid,
                  odo, compute_projector: bool):
    """One GN update against cached correspondences; returns
    (tf_new, mat_p, degenerate, done)."""
    weighted = it >= odo.weight_start_iteration
    lc = last_corner.xyz
    d_c, dir_c = _line_residual(x_c, lc[cj.long()], lc[cl.long()])
    s_c = 1.0 - odo.weight_decay * d_c.abs() if weighted else torch.ones_like(d_c)
    sel_c = cvalid & (s_c > odo.weight_floor) & (d_c != 0.0)
    coeff_c = (s_c[:, None] * dir_c) * sel_c[:, None]

    ls = last_surf.xyz
    d_s, dir_s = _plane_residual(x_s, ls[sj.long()], ls[sl.long()],
                                 ls[sm_.long()])
    dist_s = torch.sqrt(_norm(x_s))
    s_s = (1.0 - odo.weight_decay * d_s.abs() / dist_s.clamp(min=1e-6)
           if weighted else torch.ones_like(d_s))
    sel_s = svalid & (s_s > odo.weight_floor) & (d_s != 0.0)
    coeff_s = (s_s[:, None] * dir_s) * sel_s[:, None]

    a_rows = _jacobian_rows(tf, torch.cat([sharp.xyz, flat.xyz]),
                            torch.cat([coeff_c, coeff_s]))
    b_vec = torch.cat([-odo.residual_scale * s_c * d_c * sel_c,
                       -odo.residual_scale * s_s * d_s * sel_s])
    enough = (sel_c.sum() + sel_s.sum()) >= odo.min_selected

    x, ata = solve_gn(a_rows, b_vec)
    if compute_projector:
        p, dg = degeneracy_projector(ata, odo.degeneracy_eigen_threshold)
        mat_p = torch.where(enough, p, mat_p0)
        degenerate = enough & dg
    else:
        mat_p, degenerate = mat_p0, degenerate0
    x = torch.where(degenerate, mat_p @ x, x)

    tf_new = tf + x
    tf_new = torch.where(torch.isfinite(tf_new), tf_new, 0.0)
    tf_new = torch.where(enough, tf_new, tf)
    delta_r = _norm(lm.rad2deg(x[:3]))
    delta_t = _norm(x[3:] * 100.0)
    done = enough & (delta_r < odo.delta_r_abort) & (delta_t < odo.delta_t_abort)
    return tf_new, mat_p, degenerate, done


class GnCarry(NamedTuple):
    """What one GN phase hands to the next: the transform, the first
    iteration's degeneracy projector and flag, and whether the loop has
    stopped (converged, or never started because a cloud was too
    small)."""

    tf: Tensor
    mat_p: Tensor
    degenerate: Tensor
    done: Tensor


def gn_start(tf0: Tensor, run: Tensor) -> GnCarry:
    """The carry before the first phase; ``run`` False stops the GN
    before it starts."""
    return GnCarry(tf=tf0, mat_p=torch.eye(6, dtype=torch.float32,
                                           device=tf0.device),
                   degenerate=torch.zeros((), dtype=torch.bool,
                                          device=tf0.device),
                   done=~run)


def n_phases(max_iterations: int, refresh_every: int) -> int:
    """Refresh phases of a GN schedule."""
    return -(-max_iterations // refresh_every)


def _runs(last_corner: PointSet, last_surf: PointSet, odo) -> Tensor:
    return ((last_corner.count() > odo.min_corner_points)
            & (last_surf.count() > odo.min_surface_points))


def gn_phase(carry: GnCarry, phase: int, sharp: PointSet, flat: PointSet,
             last_corner: PointSet, last_surf: PointSet,
             cfg: LoamConfig) -> GnCarry:
    """Phase ``phase`` of the GN: the correspondences refreshed at the
    carried transform (K3), then the phase's iterations against them.
    An iteration after the stop is frozen by masks, so a phase computes
    what the dynamic loop computes up to its break, and changes nothing
    once the carry is done; each iteration after the phase's first is a
    conditional region (skipped on the card once the carry is done).
    ``phase`` is a Python int: it fixes which iterations are weighted
    and which computes the projector. Only the carry leaves a phase. With
    tracing on, the phase counts its lanes and its running lanes
    (``odometry.refresh``, ``ops/launches.py::lanes``)."""
    launches.lanes("odometry.refresh", carry.done)
    odo = cfg.odometry
    refresh_every = odo.corresp_refresh_every
    x_c = lm.transform_to_start(sharp.xyz, sharp.rel, carry.tf)
    x_s = lm.transform_to_start(flat.xyz, flat.rel, carry.tf)
    cm = corner_correspondences_fused(x_c, sharp.mask, last_corner,
                                      odo.ring_bracket)
    sm = surf_correspondences_fused(x_s, flat.mask, last_surf,
                                    odo.ring_bracket)

    def iteration(c: GnCarry, it: int) -> GnCarry:
        x_c_j = lm.transform_to_start(sharp.xyz, sharp.rel, c.tf)
        x_s_j = lm.transform_to_start(flat.xyz, flat.rel, c.tf)
        tf_new, mat_p_new, degen_new, done_step = _gn_iteration(
            c.tf, it, c.mat_p, c.degenerate, x_c_j, x_s_j, sharp, flat,
            last_corner, last_surf, cm.j, cm.l, cm.valid,
            sm.j, sm.l, sm.m, sm.valid, odo,
            compute_projector=(it == 0))
        active = ~c.done
        return GnCarry(torch.where(active, tf_new, c.tf),
                       torch.where(active, mat_p_new, c.mat_p),
                       torch.where(active, degen_new, c.degenerate),
                       c.done | (active & done_step))

    for j in range(refresh_every):
        it = phase * refresh_every + j
        if it >= odo.max_iterations:
            break
        body = functools.partial(iteration, it=it)
        carry = (body(carry) if j == 0
                 else conditional.run_if_running(carry.done, body, carry))
    return carry


def gn_phases(carry: GnCarry, sharp: PointSet, flat: PointSet,
              last_corner: PointSet, last_surf: PointSet,
              cfg: LoamConfig) -> GnCarry:
    """Every refresh phase of the GN from ``carry`` (``gn_phase``), each
    a conditional region: the JAX package's ``lax.while_loop`` over
    phases."""
    odo = cfg.odometry
    for phase in range(n_phases(odo.max_iterations, odo.corresp_refresh_every)):
        carry = conditional.run_if_running(
            carry.done, lambda c, p=phase: gn_phase(
                c, p, sharp, flat, last_corner, last_surf, cfg),
            carry)
    return carry


def run_gn_static(sharp: PointSet, flat: PointSet, last_corner: PointSet,
                  last_surf: PointSet, tf0: Tensor, cfg: LoamConfig) -> Tensor:
    """The fixed-phase GN: ceil(max_iterations / refresh_every) phases
    (``gn_phases``), early abort as masked freezing (and, in a CUDA
    graph, as skipped regions). Returns the refined transform."""
    carry = gn_start(tf0, _runs(last_corner, last_surf, cfg.odometry))
    return gn_phases(carry, sharp, flat, last_corner, last_surf, cfg).tf


def run_gauss_newton(sharp: PointSet, flat: PointSet, last_corner: PointSet,
                     last_surf: PointSet, tf0: Tensor, cfg: LoamConfig,
                     static_schedule: bool = True) -> Tensor:
    """The <=max_iterations GN alignment; returns the refined transform.
    ``static_schedule=False`` is the dynamic form: correspondences
    refreshed when ``it % corresp_refresh_every == 0``, the loop left at
    the first iteration whose update is below the abort thresholds (or
    at once when either previous cloud is too small), each read on the
    host."""
    if static_schedule:
        return run_gn_static(sharp, flat, last_corner, last_surf, tf0, cfg)
    odo = cfg.odometry
    if not bool(_runs(last_corner, last_surf, odo)):
        return tf0
    tf = tf0
    mat_p = torch.eye(6, dtype=torch.float32, device=tf0.device)
    degenerate = torch.zeros((), dtype=torch.bool, device=tf0.device)
    for it in range(odo.max_iterations):
        x_c = lm.transform_to_start(sharp.xyz, sharp.rel, tf)
        x_s = lm.transform_to_start(flat.xyz, flat.rel, tf)
        if it % odo.corresp_refresh_every == 0:
            cm = corner_correspondences_fused(x_c, sharp.mask, last_corner,
                                              odo.ring_bracket)
            sm = surf_correspondences_fused(x_s, flat.mask, last_surf,
                                            odo.ring_bracket)
        tf, mat_p, degenerate, done = _gn_iteration(
            tf, it, mat_p, degenerate, x_c, x_s, sharp, flat, last_corner,
            last_surf, cm.j, cm.l, cm.valid, sm.j, sm.l, sm.m, sm.valid, odo,
            compute_projector=(it == 0))
        if bool(done):
            break
    return tf


def _transform_to_end_cloud(ps: PointSet, tf: Tensor,
                            imu: ImuSweepState) -> PointSet:
    xyz = lm.transform_to_end(ps.xyz, ps.rel, tf, imu.start_rpy, imu.end_rpy,
                              imu.shift_from_start)
    return PointSet(xyz=xyz, rel=torch.zeros_like(ps.rel), ring=ps.ring,
                    mask=ps.mask)


def first_sweep(state: OdometryState, feats: SweepFeatures,
                imu: ImuSweepState) -> Tuple[OdometryState, OdometryOutputs]:
    """The step of a sequence's first sweep: no GN; the clouds are kept
    for the next sweep and the IMU's pitch / roll seed the pose."""
    ts = state.transform_sum.clone()
    ts[0] += imu.start_rpy[1]
    ts[2] += imu.start_rpy[0]
    new_state = OdometryState(
        last_corner=feats.less_sharp, last_surf=feats.less_flat,
        transform=state.transform, transform_sum=ts,
        initialized=torch.ones_like(state.initialized),
        frame=state.frame + 1)
    return new_state, OdometryOutputs(transform_sum=ts,
                                      corner_cloud=feats.less_sharp,
                                      surf_cloud=feats.less_flat)


def initial_transform(state: OdometryState, imu: ImuSweepState,
                      cfg: LoamConfig) -> Tensor:
    """The GN's start: the last sweep's motion less the IMU's velocity
    term."""
    tf0 = state.transform.clone()
    tf0[3:] += -imu.velo_from_start * cfg.registration.scan_period
    return tf0


def finish(state: OdometryState, feats: SweepFeatures, tf: Tensor,
           imu: ImuSweepState, cfg: LoamConfig
           ) -> Tuple[OdometryState, OdometryOutputs]:
    """After the GN: the pose accumulated with the sweep's motion ``tf``
    and the IMU terms, and the clouds moved to the sweep end."""
    odo = cfg.odometry
    neg_rot = torch.stack([-tf[0], -tf[1] * odo.rot_y_fudge, -tf[2]])
    rot = lm.accumulate_rotation(state.transform_sum[lm.ROT], neg_rot)
    v = torch.stack([tf[3] - imu.shift_from_start[0],
                     tf[4] - imu.shift_from_start[1],
                     tf[5] * odo.pos_z_fudge - imu.shift_from_start[2]])
    m = lm.rot_zxy_mat(rot[2], rot[0], rot[1])
    pos = state.transform_sum[lm.POS] - lm.apply_rot(m, v)
    imu_start_xyz = torch.stack([imu.start_rpy[1], imu.start_rpy[2],
                                 imu.start_rpy[0]])
    imu_end_xyz = torch.stack([imu.end_rpy[1], imu.end_rpy[2], imu.end_rpy[0]])
    rot = lm.plugin_imu_rotation(rot, imu_start_xyz, imu_end_xyz)
    transform_sum = torch.cat([rot, pos])

    corner_end = _transform_to_end_cloud(feats.less_sharp, tf, imu)
    surf_end = _transform_to_end_cloud(feats.less_flat, tf, imu)
    new_state = OdometryState(
        last_corner=corner_end, last_surf=surf_end, transform=tf,
        transform_sum=transform_sum, initialized=state.initialized,
        frame=state.frame + 1)
    return new_state, OdometryOutputs(transform_sum=transform_sum,
                                      corner_cloud=corner_end,
                                      surf_cloud=surf_end)


def select(flag: Tensor, a, b):
    """``a`` where the 0-d bool ``flag`` holds, else ``b``: two equal
    trees of (named) tuples of tensors, leaf by leaf (under vmap, each
    lane's own choice, as ``lax.cond`` under vmap selects)."""
    if isinstance(a, tuple):
        items = [select(flag, x, y) for x, y in zip(a, b)]
        return tuple(items) if type(a) is tuple else type(a)(*items)
    return torch.where(flag, a, b)


@profiling.stamped("odometry")
def step(state: OdometryState, feats: SweepFeatures, cfg: LoamConfig,
         initialized: bool | Tensor, imu: ImuSweepState | None = None,
         static_schedule: bool = True
         ) -> Tuple[OdometryState, OdometryOutputs]:
    """One sweep of odometry. ``initialized`` False on the first sweep of
    a sequence: the host's copy of ``state.initialized`` (a bool, which
    picks the branch), or the flag itself (a tensor: both branches run
    and each lane takes its own, the JAX package's ``lax.cond`` on
    ``state.initialized`` under vmap; the GN, in the static schedule,
    stops before it starts on a lane in its first sweep, so a batch of
    such lanes skips it on the card). ``imu``: this sweep's IMU summary
    (zero without one)."""
    if imu is None:
        imu = ImuSweepState.zero(state.transform.device)
    if isinstance(initialized, Tensor):
        carry = gn_start(initial_transform(state, imu, cfg),
                         _runs(state.last_corner, state.last_surf,
                               cfg.odometry) & initialized)
        tf = gn_phases(carry, feats.sharp, feats.flat, state.last_corner,
                       state.last_surf, cfg).tf
        return select(initialized, finish(state, feats, tf, imu, cfg),
                      first_sweep(state, feats, imu))
    if not initialized:
        return first_sweep(state, feats, imu)
    tf0 = initial_transform(state, imu, cfg)
    tf = run_gauss_newton(feats.sharp, feats.flat, state.last_corner,
                          state.last_surf, tf0, cfg, static_schedule)
    return finish(state, feats, tf, imu, cfg)
