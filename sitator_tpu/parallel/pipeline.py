"""Frame-sharded SPMD analysis pipeline — the flagship compiled step.

This is the multi-chip execution path for the core workload (SURVEY.md §8.2
step 6): one ``jit``-compiled function computes landmark vectors → peak
evening → normalization → site assignment → jump statistics for a block of
frames, with the frame axis sharded over a 1-D :func:`frame_mesh`.  Per-site
statistics come out replicated — XLA inserts the cross-device ``psum`` from
the scatter-add + prefix-scan structure; there is no hand-written
communication.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.ops import landmark as lmops
from sitator_tpu.ops.jumps import JumpStats, _jump_stats_parallel
from sitator_tpu.parallel.mesh import (
    frame_mesh,
    frame_sharding,
    pad_frames,
    replicated,
)

__all__ = ["SpmdLandmarkPipeline", "analysis_step", "fused_analysis_step",
           "mxu_analysis_step"]


def mxu_analysis_step(mesh, mobile, static, basis, cell, centers_perm, *,
                      midpoint, steepness, threshold,
                      cutoff_shape="logistic", mxu_bf16=True,
                      interpret=False, active_idx=None, n_sites=None,
                      peak_evening="none", valid=None, carry=None):
    """Frame-sharded analysis step on the tiled lv stage
    (:mod:`sitator_tpu.ops.landmark_mxu`) — same contract as
    :func:`fused_analysis_step`, for landmark bases that share vertices
    (``mxu_supported``)."""
    from sitator_tpu.ops.landmark_mxu import mxu_assign_blocks
    from sitator_tpu.parallel.mesh import shard_map_frames

    preshift = bool(basis.get("preshift", False))
    n_st, UP = basis["n_st"], basis["UP"]
    ref_u = (basis["ref_u"] if preshift
             else jnp.zeros((n_st, UP, 3), jnp.float32))
    anchors = (basis["anchors"] if preshift
               else jnp.zeros((n_st, 3), jnp.float32))

    def local(mobile, static, uidx, A, kill, ref_u, anchors, cell,
              centers_perm):
        return mxu_assign_blocks(
            mobile, static,
            dict(uidx=uidx, A=A, kill=kill, s_tile=basis["s_tile"],
                 n_st=n_st, UP=UP, cost_ratio=basis["cost_ratio"],
                 site_order=basis["site_order"], preshift=preshift,
                 ref_u=ref_u, anchors=anchors),
            cell, centers_perm, midpoint=midpoint, steepness=steepness,
            threshold=threshold, mxu_bf16=mxu_bf16, interpret=interpret,
            cutoff_shape=cutoff_shape, peak_evening=peak_evening)

    labels, confs = shard_map_frames(
        local, mesh, 2, mobile, static, basis["uidx"], basis["A"],
        basis["kill"], ref_u, anchors, cell, centers_perm)
    if active_idx is not None:
        labels = _remap_labels(labels, jnp.asarray(active_idx, jnp.int32))
    if n_sites is None:
        n_sites = _default_n_sites(centers_perm, active_idx)
    labels, stats = _block_stats(labels, int(n_sites), valid, carry)
    return labels, confs, stats


def fused_analysis_step(mesh, mobile, static, verts, vmask, cell,
                        centers, *, midpoint, steepness, threshold,
                        cutoff_shape="logistic", mxu_bf16=True,
                        active_idx=None, n_sites=None, peak_evening="none",
                        valid=None, carry=None):
    """Frame-sharded analysis step on the per-vertex gather path.

    The landmark step runs per shard under ``shard_map`` (as the tiled
    path's Pallas call must); the order-dependent jump statistics run on
    the sharded labels OUTSIDE the shard_map, where the associative-prefix
    formulation partitions automatically.  ``cell``: (3,) orthorhombic
    lengths or (3, 3) triclinic matrix (``ops.pbc.kernel_cell``).

    mobile (F, M, 3) / static (F, N, 3) frame-sharded over ``mesh``;
    verts/vmask/centers replicated.  ``active_idx`` (K_compact,) int32,
    optional: remap the kernel's compact labels to a caller cluster
    indexing on device (a static gather) before the jump scan; ``n_sites``
    sizes the statistics in that indexing.  Returns (labels, confs, stats).
    """
    from sitator_tpu.ops.landmark_gather import gather_assign_blocks
    from sitator_tpu.parallel.mesh import shard_map_frames

    def local(mobile, static, verts, vmask, cell, centers):
        return gather_assign_blocks(
            mobile, static, verts, vmask, cell, centers,
            midpoint=midpoint, steepness=steepness, threshold=threshold,
            mxu_bf16=mxu_bf16, cutoff_shape=cutoff_shape,
            peak_evening=peak_evening)

    labels, confs = shard_map_frames(
        local, mesh, 2, mobile, static, verts, vmask, cell, centers)
    if active_idx is not None:
        labels = _remap_labels(labels, jnp.asarray(active_idx, jnp.int32))
    if n_sites is None:
        n_sites = _default_n_sites(centers, active_idx)
    labels, stats = _block_stats(labels, int(n_sites), valid, carry)
    return labels, confs, stats


def _default_n_sites(centers, active_idx):
    """Statistics sizing when the caller omits ``n_sites``: with an
    ``active_idx`` remap the labels live in the caller's indexing (up to
    ``max(active_idx)``), not the kernel's compact 0..K-1 — sizing by the
    compact center count would silently clamp scatter indices."""
    if active_idx is not None and np.size(active_idx):
        return int(np.asarray(active_idx).max()) + 1
    return int(centers.shape[0])


def _block_stats(labels, n_sites, valid, carry):
    """Jump statistics for one block.

    ``valid (F,)`` masks padding frames to label −1 (the unknown-frame
    policy makes them exact no-ops — same trick as the streaming engine).
    ``carry = (last_sites, last_res)`` chains residences across blocks via
    the sequential scan; without it the associative-prefix formulation is
    used (partitions over a frame mesh)."""
    from sitator_tpu.ops.jumps import _jump_stats

    if valid is not None:
        labels = jnp.where(jnp.asarray(valid)[:, None], labels, -1)
    if carry is not None:
        stats = _jump_stats(labels, n_sites, init_last=jnp.asarray(carry[0]),
                            init_res=jnp.asarray(carry[1]))
    else:
        stats = _jump_stats_parallel(labels, n_sites)
    return labels, stats


@jax.jit
def _remap_labels(labels, active_idx):
    """Compact cluster labels → caller indexing; −1 (unknown) passes through."""
    return jnp.where(labels >= 0,
                     active_idx[jnp.maximum(labels, 0)],
                     jnp.int32(-1))


@partial(jax.jit,
         static_argnames=("n_sites", "peak_evening", "matmul_dtype",
                          "cutoff_shape"))
def analysis_step(mobile, static, A, cell, cell_inv, centers, active,
                  cutoff_midpoint, cutoff_steepness, assignment_threshold,
                  n_sites, peak_evening="none", matmul_dtype=None,
                  cutoff_shape="logistic", valid=None, carry=None):
    """Pure jittable analysis step (single- or multi-chip; sharding comes
    from the argument placements).

    mobile (F, M, 3), static (F, N, 3) — frame-sharded under a mesh;
    A (N, S_landmark), centers (K, S_landmark), active (K,) — replicated.
    Returns (labels (F, M), confs (F, M), jump-stats dict over ``n_sites``).
    """
    lv = lmops.landmark_vectors(mobile, static, A, cell, cell_inv,
                                cutoff_midpoint, cutoff_steepness,
                                matmul_dtype=matmul_dtype,
                                cutoff_shape=cutoff_shape)
    lv = lmops.peak_even(lv, peak_evening)
    lv_n, _ = lmops.normalize_landmark_vectors(lv)
    labels, confs = lmops.assign_to_centers(lv_n, centers, active,
                                            assignment_threshold,
                                            matmul_dtype=matmul_dtype)
    labels, stats = _block_stats(labels, n_sites, valid, carry)
    return labels, confs, stats


class SpmdLandmarkPipeline:
    """Bind a fitted analysis (landmark basis + cluster centers) to a device
    mesh and stream frame blocks through :func:`analysis_step`.

    Parameters
    ----------
    seed_sn : SiteNetwork with vertices — the landmark basis.
    centers : (K, S_landmark) fitted cluster centers (unit rows).
    active : (K,) bool — live clusters; ``n_sites`` = K (labels use the
        fitted cluster indexing).
    mesh : a 1-D device mesh (default: all devices).
    """

    def __init__(self, seed_sn, centers, active, *, cutoff_midpoint,
                 cutoff_steepness, assignment_threshold=0.35,
                 peak_evening="none", mesh=None, use_fused="auto",
                 cutoff_shape="logistic", interpret=False,
                 static_drift_budget=3.0):
        # static_drift_budget (Å): how far static atoms may drift from the
        # seed structure — the tile-preshift exactness bound budgets for
        # it (prepare_mxu_basis vibration_margin); None disables preshift
        # for unbounded-drift inputs (this pipeline has no drift guard of
        # its own — the streaming engine's guard enforces its threshold)
        self.static_drift_budget = static_drift_budget
        self.mesh = mesh if mesh is not None else frame_mesh()
        self.n_devices = self.mesh.devices.size
        self.peak_evening = peak_evening
        self.cutoff_midpoint = float(cutoff_midpoint)
        self.cutoff_steepness = float(cutoff_steepness)
        self.assignment_threshold = float(assignment_threshold)
        self.cutoff_shape = cutoff_shape
        self.interpret = bool(interpret)
        # the tiled and gather paths handle every configuration
        # (orthorhombic and triclinic cells, peak_evening='clip'); the
        # dense route runs only when asked for (use_fused=False)
        self.use_fused = use_fused in ("auto", True)

        self.mobile_idx = np.flatnonzero(seed_sn.mobile_mask)
        self.static_idx = np.flatnonzero(seed_sn.static_mask)
        verts, vmask = seed_sn.padded_vertices()
        rep = replicated(self.mesh)
        self.verts = jax.device_put(jnp.asarray(verts), rep)
        self.vmask = jax.device_put(jnp.asarray(vmask), rep)
        from sitator_tpu.ops.pbc import kernel_cell
        self.kcell = jax.device_put(kernel_cell(seed_sn.structure.cell), rep)
        # fused path uses compacted (live-row) centers; labels are remapped
        # back to the caller's cluster indexing on the way out
        self._active_idx = np.flatnonzero(np.asarray(active))
        self._active_idx_j = jax.device_put(
            jnp.asarray(self._active_idx, jnp.int32), rep)
        centers_compact = np.asarray(centers)[self._active_idx]
        self._centers_compact = jax.device_put(
            jnp.asarray(centers_compact, jnp.float32), rep)
        # tiled route whenever the basis shares vertices
        self._mxu_basis = None
        if self.use_fused:
            from sitator_tpu.ops.landmark_mxu import (permute_centers,
                                                      prepare_engine_basis)
            basis = prepare_engine_basis(
                verts, vmask, seed_sn.centers, seed_sn.structure.cell,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape,
                static_ref=seed_sn.structure.positions[self.static_idx],
                drift_budget=self.static_drift_budget)
            if basis is not None:
                keys = ["uidx", "A", "kill"]
                if basis["preshift"]:
                    keys += ["ref_u", "anchors"]
                for k in keys:
                    basis[k] = jax.device_put(basis[k], rep)
                self._mxu_basis = basis
                self._centers_mxu = jax.device_put(
                    jnp.asarray(permute_centers(centers_compact, basis),
                                jnp.float32), rep)
        # the dense membership matrix feeds only the dense branch of
        # run_block; on the other routes it is ~n_static x n_landmarks
        # x 4 B of dead device weight
        self.A = (None if self.use_fused else jax.device_put(
            lmops.vertex_membership_matrix(verts, vmask,
                                           len(self.static_idx)), rep))
        self.cell = jax.device_put(
            jnp.asarray(seed_sn.structure.cell, jnp.float32), rep)
        self.cell_inv = jax.device_put(
            jnp.asarray(np.linalg.inv(seed_sn.structure.cell), jnp.float32),
            rep)
        self.centers = jax.device_put(jnp.asarray(centers, jnp.float32), rep)
        self.active = jax.device_put(jnp.asarray(active, bool), rep)
        self.n_sites = int(centers.shape[0])
        from sitator_tpu.ops.kernel_common import lv_impl
        self.kernel_path_ = (
            f"tiled:{lv_impl(self.interpret)}" if self._mxu_basis is not None
            else "gather" if self.use_fused else "dense")

    def run_block(self, frames, carry=None):
        """Run one frame block (host array (B, n_atoms, 3)); B is padded to a
        multiple of the mesh size (padding frames are masked out of the
        statistics exactly).  Returns (labels, confs, JumpStats) as host
        arrays covering the original B frames.

        To chain jump statistics across consecutive blocks, pass
        ``carry=(prev_stats["last_sites"], prev_stats["last_res"])`` from
        the previous block — boundary jumps and residences then connect
        exactly, as in the streaming engine."""
        frames = np.asarray(frames)
        padded, n_valid = pad_frames(frames, self.n_devices)
        valid = (None if n_valid == len(padded)
                 else jnp.asarray(np.arange(len(padded)) < n_valid))
        sh = frame_sharding(self.mesh)
        mobile = jax.device_put(
            padded[:, self.mobile_idx].astype(np.float32), sh)
        static = jax.device_put(
            padded[:, self.static_idx].astype(np.float32), sh)
        if self.use_fused and self._mxu_basis is not None:
            labels, confs, stats = mxu_analysis_step(
                self.mesh, mobile, static, self._mxu_basis, self.kcell,
                self._centers_mxu, midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                threshold=self.assignment_threshold,
                cutoff_shape=self.cutoff_shape, interpret=self.interpret,
                active_idx=self._active_idx_j, n_sites=self.n_sites,
                peak_evening=self.peak_evening, valid=valid, carry=carry)
        elif self.use_fused:
            labels, confs, stats = fused_analysis_step(
                self.mesh, mobile, static, self.verts, self.vmask,
                self.kcell, self._centers_compact,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                threshold=self.assignment_threshold,
                cutoff_shape=self.cutoff_shape,
                active_idx=self._active_idx_j, n_sites=self.n_sites,
                peak_evening=self.peak_evening, valid=valid, carry=carry)
        else:
            labels, confs, stats = analysis_step(
                mobile, static, self.A, self.cell, self.cell_inv,
                self.centers, self.active, self.cutoff_midpoint,
                self.cutoff_steepness, self.assignment_threshold,
                self.n_sites, self.peak_evening,
                cutoff_shape=self.cutoff_shape, valid=valid, carry=carry)
        labels = np.asarray(labels)[:n_valid]
        confs = np.asarray(confs)[:n_valid]
        return labels, confs, JumpStats(
            {k: np.asarray(v) for k, v in stats.items()})
