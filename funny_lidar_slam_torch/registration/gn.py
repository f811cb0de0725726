"""Gauss-Newton iteration loop of the scan-to-map matcher (port of
registration/gn.py).

The JAX package keeps the whole loop on the device in one
`lax.while_loop`. Here two routes run it:
  * the round drivers over cached candidates keep the iterations on the
    device: between two gathers they run in one launch of csrc/gn_loop.cu
    (ops/gn_loop.py), and the host reads one status word a gather round.
    `run_gn_icp_cand` serves IcpMatcher (point-to-point rows),
    `run_gn_plane_cand` PointToPlaneMatcher (point-to-plane rows) and
    `run_gn_loam_cand` LoamFullMatcher (point-to-line rows of the corner
    set plus point-to-plane rows of the planar set). `run_gn_ndt` serves
    NdtMatcher and the loop closure's NDT stages, `run_gn_plane_map` the
    loop closure's point-to-plane refine (backend/loop_closure.py): each
    kernel makes the lookup of every iteration itself (NDT's stencil, the
    block map's 5 nearest), so the whole loop is one launch and one host
    read;
  * `run_gn_corr` (and `run_gn` over it) runs the loop on the host and
    reads its control flags (done, converged, the trust-region test) back
    once per iteration, one small copy that waits for the iteration to
    finish. No path on the card calls it: it serves the CPU, the tests and
    the tools, as the route the round drivers are held against.
The semantics of both are those of the JAX loop: the trust-region re-gather
skip, `force_gather`, the exact/stall rules, and `iters` counting gathers.

Update conventions (`GNConfig.update`, matching the reference):
  UPDATE_ICP:  dx = [t, r]; P += dt; R := R Exp(dr)
  UPDATE_LOAM: dx = [r, t]; R := Exp(dr) R; P += dt
  UPDATE_NDT:  dx = [r, t]; R := R Exp(dr); P += dt
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core.lie import so3_exp
from ..ops import gn_loop
# looked up here at call time, so that a run can wrap the driver's calls
from ..ops.gn_loop import (
    icp_gn_rounds,
    loam_gn_rounds,
    ndt_gn_rounds,
    plane_gn_rounds,
    plane_map_gn_rounds,
    trust_region_moved,
)
from ..ops.lin3 import solve6_damped
from .residuals import HG, CandSet

UPDATE_ICP = "icp"
UPDATE_LOAM = "loam"
UPDATE_NDT = "ndt"


class GNConfig(NamedTuple):
    max_iters: int = 30
    rotation_eps: float = 0.05
    position_eps: float = 0.01
    stall_eps: float = 1.0e-4
    update: str = UPDATE_LOAM
    use_stall_check: bool = True  # the LOAM matchers only, in the reference
    # convergence requires at least this many valid correspondences
    min_valid: int = 10
    # correspondence-cache schedule: the gather runs every `corr_every`
    # iterations; the ones in between re-linearize on the cached candidates
    corr_every: int = 1
    # trust-region re-gather skip: while the pose has moved less than this
    # (translation + rotation scaled by the source radius) since the gather,
    # re-selection among cached candidates is exact and no gather runs.
    # 0 disables the skip.
    skip_regather_dist: float = 0.0
    regather_radius: float = 20.0


class GNResult(NamedTuple):
    t_mat: torch.Tensor  # [4, 4] final pose
    converged: torch.Tensor  # [] bool (dx-based convergence reached)
    iters: torch.Tensor  # [] int32 gathers
    num_valid: torch.Tensor  # [] int32 valid correspondences at last iteration
    total_res: torch.Tensor  # [] residual sum at last iteration


def apply_update(t_mat: torch.Tensor, dx: torch.Tensor, update: str) -> torch.Tensor:
    out = t_mat.clone()
    if update == UPDATE_ICP:
        out[:3, 3] += dx[:3]
        out[:3, :3] = t_mat[:3, :3] @ so3_exp(dx[3:])
    elif update == UPDATE_LOAM:
        out[:3, :3] = so3_exp(dx[:3]) @ t_mat[:3, :3]
        out[:3, 3] += dx[3:]
    elif update == UPDATE_NDT:
        out[:3, :3] = t_mat[:3, :3] @ so3_exp(dx[:3])
        out[:3, 3] += dx[3:]
    else:
        raise ValueError(update)
    return out


def _dx_split(dx: torch.Tensor, update: str):
    """(rotation, position) parts of an update."""
    if update == UPDATE_ICP:
        return dx[3:], dx[:3]
    return dx[:3], dx[3:]


def run_gn(hg_fn: Callable[[torch.Tensor], HG], t0: torch.Tensor, cfg: GNConfig) -> GNResult:
    """Iterate GN from `t0` with residual evaluator `hg_fn(T) -> HG`,
    re-gathering every iteration (the reference semantics)."""
    return run_gn_corr(lambda t: None, lambda t, _corr: hg_fn(t), t0,
                       cfg._replace(corr_every=1))


def run_gn_corr(
    corr_fn: Callable[[torch.Tensor], object],
    hg_fn: Callable[[torch.Tensor, object], HG],
    t0: torch.Tensor,
    cfg: GNConfig,
    regather_radius=None,
) -> GNResult:
    """Two-loop GN: `corr_fn(T)` produces the (expensive) candidate set,
    `hg_fn(T, corr)` linearizes on it. The gather runs on iteration 0, then
    every `cfg.corr_every` iterations or right after an iteration that
    settled on stale matches outside the trust region, so `converged` is
    only declared on exact linearizations."""
    dtype, dev = t0.dtype, t0.device
    radius = torch.as_tensor(cfg.regather_radius if regather_radius is None
                             else regather_radius, dtype=dtype, device=dev)
    max_total = cfg.max_iters * max(int(cfg.corr_every), 1)
    skip = cfg.skip_regather_dist > 0.0

    t_mat = t_gather = t0
    corr = None
    it = gathers = since_gather = 0
    force_gather = done = converged = False
    moved = True
    last_rot = last_pos = torch.tensor(1e9, dtype=dtype, device=dev)
    num_valid = torch.zeros((), dtype=torch.int32, device=dev)
    total_res = torch.zeros((), dtype=dtype, device=dev)

    while gathers < cfg.max_iters and it < max_total and not done:
        want = since_gather >= cfg.corr_every or force_gather
        refresh = (want and moved) or it == 0
        if refresh:
            corr = corr_fn(t_mat)
            t_gather = t_mat
        hg = hg_fn(t_mat, corr)
        dx = solve6_damped(hg.h, hg.g)
        t_mat = apply_update(t_mat, dx, cfg.update)
        rot, pos = _dx_split(dx, cfg.update)
        rn, pn = torch.linalg.vector_norm(rot), torch.linalg.vector_norm(pos)
        enough = hg.num_valid >= cfg.min_valid
        conv = (rn < cfg.rotation_eps) & (pn < cfg.position_eps) & enough
        # linearizations that are fresh OR still inside the trust region
        # (re-selection provably matches a fresh gather) count as exact
        exact = refresh or not moved
        if cfg.use_stall_check and exact:
            stall = ((torch.abs(rn - last_rot) < cfg.stall_eps)
                     & (torch.abs(pn - last_pos) < cfg.stall_eps))
        else:
            stall = torch.zeros((), dtype=torch.bool, device=dev)
        if exact:
            last_rot, last_pos = rn, pn
        nxt_moved = (trust_region_moved(t_mat, t_gather, radius, cfg.skip_regather_dist) if skip
                     else torch.ones((), dtype=torch.bool, device=dev))
        # the one host read of the iteration
        settled_h, conv_h, nxt_moved_h = torch.stack(
            [conv | stall, conv | (stall & enough), nxt_moved]).tolist()
        it += 1
        gathers += int(refresh)
        since_gather = 1 if refresh else since_gather + 1
        force_gather = settled_h and not exact
        done = settled_h and exact
        converged = conv_h and exact
        moved = nxt_moved_h
        num_valid, total_res = hg.num_valid, hg.total_res

    return GNResult(
        t_mat,
        torch.tensor(converged, device=dev),
        torch.tensor(gathers, dtype=torch.int32, device=dev),
        num_valid,
        total_res,
    )


def _host_read(flags: torch.Tensor) -> list:
    """The one host read of a gather round: the status word and, when the
    caller asked for one, its gate, in one small copy."""
    return flags.tolist()


def _run_rounds(driver, rounds, corr_fn, t0, cfg, regather_radius, gate_fn):
    """The gather rounds of `driver`: gather at the carry's pose (on the
    device, no read), run the iterations up to the next gather in one
    `rounds(carry, cand, radius)` call, read the status word (and the
    gate) in one copy, and stop on DONE."""
    dev = t0.device
    radius = (torch.full((), cfg.regather_radius, dtype=torch.float32, device=dev)
              if regather_radius is None else regather_radius)
    carry = gn_loop.init_carry(t0)
    res = GNResult(*gn_loop.result_views(carry))
    o = gn_loop.OFFSET["status"]
    while True:
        status = rounds(carry, corr_fn(res.t_mat), radius)
        driver.rounds += 1
        flags = (carry[o:o + 1] if gate_fn is None
                 else torch.stack([status, gate_fn(res).to(torch.int32)]))
        read = _host_read(flags)
        if read[0] == gn_loop.DONE:
            return res, (bool(read[1]) if gate_fn is not None else None)
        if read[0] != gn_loop.NEED_GATHER:
            raise RuntimeError(f"{driver.__name__}: status word {read[0]}")


def _check_update(driver, cfg, update):
    if cfg.update != update:
        raise ValueError(f"{driver.__name__}: the {update.upper()} update, not {cfg.update!r}")


def run_gn_icp_cand(
    corr_fn: Callable[[torch.Tensor], CandSet],
    t0: torch.Tensor,
    cfg: GNConfig,
    max_corr_dist_sq: float,
    regather_radius=None,
    gate_fn: Callable[[GNResult], torch.Tensor] | None = None,
) -> tuple[GNResult, bool | None]:
    """`run_gn_corr` with the ICP update and `point_to_point_hg_cand` on the
    candidates of `corr_fn(T)`, in gather rounds: gather at the carry's
    pose (on the device, no read), run the iterations up to the next gather
    in one `icp_gn_rounds` call (the kernel on CUDA tensors, the plain
    version on CPU tensors), read the status word, and stop on DONE.

    `gate_fn(result)`, if given, is evaluated on the device after each call
    and read in the same copy as the status word; returns (the result,
    views of the loop's carry; the gate of the last round as a host bool,
    or None)."""
    _check_update(run_gn_icp_cand, cfg, UPDATE_ICP)
    return _run_rounds(
        run_gn_icp_cand,
        lambda carry, cand, radius: icp_gn_rounds(carry, cand, radius, cfg, max_corr_dist_sq),
        corr_fn, t0, cfg, regather_radius, gate_fn)


def run_gn_plane_cand(
    corr_fn: Callable[[torch.Tensor], CandSet],
    t0: torch.Tensor,
    cfg: GNConfig,
    plane_thresh: float,
    max_search_dist_sq: float,
    regather_radius=None,
    gate_fn: Callable[[GNResult], torch.Tensor] | None = None,
) -> tuple[GNResult, bool | None]:
    """`run_gn_icp_cand`'s rounds with the LOAM update and
    `point_to_plane_hg_cand` (`plane_gn_rounds`). Returns (the result,
    views of the carry; the last round's gate as a host bool, or None)."""
    _check_update(run_gn_plane_cand, cfg, UPDATE_LOAM)
    return _run_rounds(
        run_gn_plane_cand,
        lambda carry, cand, radius: plane_gn_rounds(carry, cand, radius, cfg, plane_thresh,
                                                    max_search_dist_sq),
        corr_fn, t0, cfg, regather_radius, gate_fn)


def run_gn_loam_cand(
    corr_fn: Callable[[torch.Tensor], tuple[CandSet, CandSet]],
    t0: torch.Tensor,
    cfg: GNConfig,
    line_ratio_thresh: float,
    plane_thresh: float,
    max_search_dist_sq: float,
    regather_radius=None,
    gate_fn: Callable[[GNResult], torch.Tensor] | None = None,
) -> tuple[GNResult, bool | None]:
    """`run_gn_icp_cand`'s rounds with the LOAM update on the (corner,
    planar) candidate sets of `corr_fn(T)`: line rows of the corner set
    plus plane rows of the planar set, the planar count as `num_valid`
    (`loam_gn_rounds`). Returns (the result, views of the carry; the last
    round's gate as a host bool, or None)."""
    _check_update(run_gn_loam_cand, cfg, UPDATE_LOAM)
    return _run_rounds(
        run_gn_loam_cand,
        lambda carry, cand, radius: loam_gn_rounds(carry, *cand, radius, cfg,
                                                   line_ratio_thresh, plane_thresh,
                                                   max_search_dist_sq),
        corr_fn, t0, cfg, regather_radius, gate_fn)


def _run_inside(driver, rounds, t0: torch.Tensor) -> GNResult:
    """The one call of a driver whose kernel gathers inside the loop:
    `rounds(carry)` runs the loop from t0 to its end, then one host read of
    the status word. Returns the result, views of the loop's carry."""
    carry = gn_loop.init_carry(t0)
    rounds(carry)
    driver.rounds += 1
    o = gn_loop.OFFSET["status"]
    status = _host_read(carry[o:o + 1])[0]
    if status != gn_loop.DONE:
        raise RuntimeError(f"{driver.__name__}: status word {status}")
    return GNResult(*gn_loop.result_views(carry))


def run_gn_ndt(src: torch.Tensor, src_mask: torch.Tensor, m, inv_voxel_size,
               outlier_thresh: float, t0: torch.Tensor, cfg: GNConfig) -> GNResult:
    """`run_gn_corr(ndt_corr, ndt_hg_corr)` with the NDT update on the map
    `m`: every iteration looks up the source's stencil voxels at its pose
    and linearizes the Mahalanobis rows, all in one `ndt_gn_rounds` call
    (the kernel on CUDA tensors, the plain version on CPU tensors) that
    runs the loop to its end, then one host read of the status word. Every
    iteration gathers (`corr_every` 1, no trust-region skip; the wrapper
    refuses others), so `iters` counts the iterations. Returns the result,
    views of the loop's carry."""
    _check_update(run_gn_ndt, cfg, UPDATE_NDT)
    return _run_inside(run_gn_ndt, lambda carry: ndt_gn_rounds(
        carry, src, src_mask, m, inv_voxel_size, outlier_thresh, None, cfg), t0)


def run_gn_plane_map(src: torch.Tensor, src_mask: torch.Tensor, m, inv_voxel_size,
                     plane_thresh: float, max_search_dist_sq: float, t0: torch.Tensor,
                     cfg: GNConfig, stencil: str = "nearby26",
                     num_probes: int = 8) -> GNResult:
    """`run_gn(point_to_plane_hg)` with the LOAM update on the hashed block
    map `m` (the loop closure's refine): every iteration gathers the
    source's 5 nearest map points at its pose, fits their planes and
    linearizes, all in one `plane_map_gn_rounds` call (the kernel on CUDA
    tensors, the plain version on CPU tensors) that runs the loop to its
    end, then one host read of the status word. Every iteration gathers
    (`corr_every` 1, no trust-region skip, the nearby26 stencil; the
    wrapper refuses others), so `iters` counts the iterations. Returns the
    result, views of the loop's carry."""
    _check_update(run_gn_plane_map, cfg, UPDATE_LOAM)
    return _run_inside(run_gn_plane_map, lambda carry: plane_map_gn_rounds(
        carry, src, src_mask, m, inv_voxel_size, plane_thresh, max_search_dist_sq, None, cfg,
        stencil, num_probes), t0)


# gather rounds run by each driver, each one host read (NDT: one a match;
# the refine: one a call)
run_gn_icp_cand.rounds = 0
run_gn_plane_cand.rounds = 0
run_gn_loam_cand.rounds = 0
run_gn_ndt.rounds = 0
run_gn_plane_map.rounds = 0
ROUND_DRIVERS = {"icp_gn_rounds": run_gn_icp_cand, "plane_gn_rounds": run_gn_plane_cand,
                 "loam_gn_rounds": run_gn_loam_cand, "ndt_gn_rounds": run_gn_ndt,
                 "plane_map_gn_rounds": run_gn_plane_map}
