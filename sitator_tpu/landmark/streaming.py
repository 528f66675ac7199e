"""``StreamingLandmarkAnalysis`` — the out-of-core / pod-scale pipeline.

BASELINE.md config 5: a 1M-frame × 10k-atom trajectory is ~120 GB of fp32
positions — far beyond HBM.  This pipeline streams it (SURVEY.md §6.7):

- **pass 1 (fit)**: landmark vectors on an evenly-strided frame subsample →
  on-device dot-product clustering → fixed cluster centers;
- **pass 2 (stream)**: :class:`ChunkedFeeder` prefetches frame blocks on a
  host thread while the device runs the landmark→assign step (the tiled
  lv stage — a Triton kernel on a GPU — plus XLA assign; orthorhombic AND
  triclinic cells; under a mesh it runs per shard via ``shard_map``),
  accumulating per-site statistics *on device*: occupancy
  counts, confidence sums, toroidal (circular-mean) center accumulators,
  the multiple-occupancy violation counter, and the jump scan whose
  (last-site, residence) carry chains exactly across blocks.  Device
  epochs spill into exact int64/float64 host totals, so long runs neither
  wrap int32 nor stall fp32 accumulation.  The residual hazard — a
  residence-weighted tally (``lag_sum``/``res_sum``) whose increment
  within one epoch exceeds int32 range via huge CARRIED residences — is
  self-healing: a sound pre-epoch bound (Σ carried residences +
  2·M·block·spill_every, checked at every spill/resume boundary) routes
  hazardous epochs through an exact host-side int64 jump scan, exactly as
  :func:`sitator_tpu.ops.jumps.jump_stats_exact` does for the classic
  path, and returns to the fast on-device scan once the bound clears.
  Exact at any frame count with no user action.  Labels can optionally
  spill to a memmapped ``.npy``.

Result: an annotated :class:`SiteNetwork` (centers, occupancies, n_ij,
p_ij, jump_lag, residence_times) without the trajectory or the label
matrix ever being resident in host memory at once.
"""
from __future__ import annotations

import logging
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.core.sitenet import SiteNetwork
from sitator_tpu.io.formats import ArrayTrajectory, ChunkedFeeder
from sitator_tpu.ops import landmark as lmops
from sitator_tpu.ops.cluster import dotprod_fit
from sitator_tpu.ops.jumps import _jump_stats, _jump_stats_block_int64
from sitator_tpu.ops.kernel_common import lv_impl
from sitator_tpu.ops.landmark_gather import (gather_assign_blocks,
                                             gather_landmark_vectors)
from sitator_tpu.ops.pbc import kernel_cell

logger = logging.getLogger(__name__)


class _Phase:
    """Accumulate host wall time of one named engine phase into a dict
    (``engine.phase_times_``).  ~100 ns per use — negligible against a
    512-frame block, so it is always on.  Phases are DISJOINT in every
    mode (``fetch_labels`` runs outside the ``dispatch_fold`` block, and
    exact-jump mode's host scan is its own ``host_jump_scan`` phase), so
    the phase sum vs total wall splits the run into host-dwell
    categories.  Recorded phases: feeder, upload, dispatch_assign,
    dispatch_fold, host_jump_scan (exact mode only), drift_fetch,
    labels_fetch, labels_memmap_write, epoch_spill, checkpoint, setup,
    finalize."""

    __slots__ = ("pt", "name", "t0")

    def __init__(self, pt, name):
        self.pt = pt
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.pt[self.name] = (self.pt.get(self.name, 0.0)
                              + time.perf_counter() - self.t0)


def _timed_iter(it, pt, name):
    it = iter(it)
    while True:
        with _Phase(pt, name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def _pack12(labels):
    """Device-side 12-bit label pack for the egress stream.

    ``labels`` (B, N) int32 in [-1, 4094] are biased by +1 (unknown −1
    becomes 0) and packed 4-per-3 into int16 words, cutting the one
    large device→host label transfer a further 25% below the int16
    egress.  Groups of 4 biased 12-bit values (a, b, c, d) become
    ``a | b<<12``, ``b>>4 | c<<8``, ``c>>8 | d<<4`` — pure uint16
    elementwise ops, fused by XLA into the assign program for free.
    N is zero-padded to a multiple of 4 (biased 0 = unknown, sliced
    off again by :func:`_unpack12`).  Inverse: :func:`_unpack12`.
    """
    n_frames, n = labels.shape
    pad = (-n) % 4
    v = (labels + 1).astype(jnp.uint16)
    if pad:
        v = jnp.pad(v, ((0, 0), (0, pad)))
    v = v.reshape(n_frames, -1, 4)
    a, b, c, d = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    w = jnp.stack([a | (b << 12),
                   (b >> 4) | (c << 8),
                   (c >> 8) | (d << 4)], axis=-1)
    return jax.lax.bitcast_convert_type(w, jnp.int16).reshape(n_frames, -1)


def pack12_width(n_mobile):
    """Egress columns used by the 12-bit pack for ``n_mobile`` labels."""
    return 3 * ((n_mobile + 3) // 4)


def _unpack12(arr, n):
    """Host-side inverse of :func:`_pack12`.

    ``arr`` is the fetched (B, 3·⌈n/4⌉) int16 egress slab; returns
    (B, n) int16 labels with −1 restored for unknown.  Vectorized
    numpy over ~0.5 MB per block — negligible next to the transfer.
    """
    w = np.ascontiguousarray(arr).view(np.uint16)
    w = w.reshape(arr.shape[0], -1, 3)
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    a = w0 & np.uint16(0xFFF)
    b = (w0 >> 12) | ((w1 & np.uint16(0xFF)) << 4)
    c = (w1 >> 8) | ((w2 & np.uint16(0xF)) << 8)
    d = w2 >> 4
    out = np.stack([a, b, c, d], axis=-1).reshape(arr.shape[0], -1)
    return out[:, :n].astype(np.int16) - np.int16(1)


@partial(jax.jit, static_argnames=("kernel", "midpoint",
                                   "steepness", "threshold",
                                   "cutoff_shape", "mesh",
                                   "interpret", "mxu_preshift",
                                   "want_drift", "egress_int16",
                                   "egress_pack12", "pack_drift"))
def _assign_block(mobile, static, verts, vmask, A, cell, cell_inv,
                  kcell, centers, active, uidx, Am, kill, mxu_ref_u,
                  mxu_anchors, static_ref, *,
                  kernel, midpoint, steepness, threshold,
                  cutoff_shape="logistic", mesh=None,
                  interpret=False, mxu_preshift=False, want_drift=True,
                  egress_int16=False, egress_pack12=False,
                  pack_drift=False):
    """Assign one streamed block: (labels, confs, drift, labels_egress).

    ``kernel``: 'tiled' (unique-atom tiled lv stage — centers arrive
    column-permuted, uidx/Am/kill are its basis arrays), 'gather'
    (per-vertex plain path), or 'dense' (the dense log-matmul route,
    ``use_fused=False``).  With ``mesh`` set (a 1-D frame mesh, hashable →
    static), the landmark paths run per shard via
    :func:`shard_map_frames`; the drift
    reduction and the downstream accumulators auto-partition over the
    frame-sharded data.  ``want_drift=False`` (guard disabled) skips the
    drift computation and returns None for it."""
    from sitator_tpu.parallel.mesh import shard_map_frames

    if kernel == "tiled":
        from sitator_tpu.ops.landmark_mxu import mxu_assign_blocks

        def assign_mxu(mobile, static, uidx, Am, kill, ref_u, anchors,
                       kcell, centers):
            return mxu_assign_blocks(
                mobile, static,
                dict(uidx=uidx, A=Am, kill=kill, preshift=mxu_preshift,
                     n_st=Am.shape[0], UP=uidx.shape[1], ref_u=ref_u,
                     anchors=anchors),
                kcell, centers, midpoint=midpoint, steepness=steepness,
                threshold=threshold, cutoff_shape=cutoff_shape,
                interpret=interpret)

        if mesh is not None:
            labels, confs = shard_map_frames(
                assign_mxu, mesh, 2,
                mobile, static, uidx, Am, kill, mxu_ref_u, mxu_anchors,
                kcell, centers)
        else:
            labels, confs = assign_mxu(mobile, static, uidx, Am, kill,
                                       mxu_ref_u, mxu_anchors,
                                       kcell, centers)
    elif kernel == "gather":
        def assign_gather(mobile, static, verts, vmask, kcell, centers):
            return gather_assign_blocks(
                mobile, static, verts, vmask, kcell, centers,
                midpoint=midpoint, steepness=steepness,
                threshold=threshold, cutoff_shape=cutoff_shape)

        if mesh is not None:
            labels, confs = shard_map_frames(
                assign_gather, mesh, 2,
                mobile, static, verts, vmask, kcell, centers)
        else:
            labels, confs = assign_gather(mobile, static, verts, vmask,
                                          kcell, centers)
    else:
        lv = lmops.landmark_vectors(mobile, static, A, cell, cell_inv,
                                    midpoint, steepness,
                                    cutoff_shape=cutoff_shape)
        lv_n, _ = lmops.normalize_landmark_vectors(lv)
        labels, confs = lmops.assign_to_centers(lv_n, centers, active,
                                                threshold)

    drift = (lmops.static_drift_per_frame(static, static_ref, cell,
                                          cell_inv)
             if want_drift else None)
    # label EGRESS copy: labels leave the device once per block (memmap
    # spill / exact-mode host scan); with any practical site count they
    # fit int16, halving the engine's one large device->host stream (the
    # on-device labels stay int32 for the accumulators; −1 is preserved).
    # With ``pack_drift`` (opt-in, requires the drift guard + int16
    # egress), the per-frame drift rides along as two extra int16 columns
    # (a bitcast of its f32), so the pipelined retirement needs ONE
    # device->host fetch per block instead of two.
    if egress_pack12:
        assert egress_int16  # engine gates pack12 inside the int16 regime
        labels_eg = _pack12(labels)
    else:
        labels_eg = labels.astype(jnp.int16) if egress_int16 else labels
    if pack_drift:
        assert want_drift and egress_int16
        drift_i16 = jax.lax.bitcast_convert_type(
            drift.astype(jnp.float32), jnp.int16)        # (B, 2)
        labels_eg = jnp.concatenate([labels_eg, drift_i16], axis=1)
    return labels, confs, drift, labels_eg


_gather_lv = jax.jit(gather_landmark_vectors,
                     static_argnames=("midpoint", "steepness",
                                      "cutoff_shape"))


@partial(jax.jit, static_argnames=("n_sites", "max_mobile", "want_jumps"))
def _accum_block(labels, confs, mobile, cell_inv, valid, carry, acc, *,
                 n_sites, max_mobile=None, want_jumps=True):
    """Fold one block's assignments into the device accumulators.

    ``valid (B,)`` masks which frames count: invalid frames become
    all-unknown (label −1) which, by the jump scan's unknown-frame policy,
    neither emits jumps nor advances residences and keeps the carry — so
    block padding and partial (re)processing are EXACT, with no host-side
    correction arithmetic.  ``carry`` = (last, res) chains across calls.

    ``want_jumps=False`` skips the on-device jump scan and its int32
    tallies (and passes ``carry`` through untouched): the engine uses this
    in the exact-residence regime, where jump statistics for the block are
    instead computed on the host in int64 (see ``run``)."""
    labels = jnp.where(valid[:, None], labels, -1)

    # per-site accumulators (dummy slot S for unassigned/invalid)
    S = n_sites
    flat = jnp.where(labels >= 0, labels, S).ravel()
    w = jnp.where(labels >= 0, confs, 0.0).ravel()
    # toroidal mean accumulators over fractional coords
    frac = jnp.matmul(mobile.reshape(-1, 3), cell_inv,
                      precision=jax.lax.Precision.HIGHEST) * (2.0 * jnp.pi)
    acc = dict(acc)
    acc["occ"] = acc["occ"].at[flat].add(1)
    acc["conf"] = acc["conf"].at[flat].add(w)
    acc["cos"] = acc["cos"].at[flat].add(w[:, None] * jnp.cos(frac))
    acc["sin"] = acc["sin"].at[flat].add(w[:, None] * jnp.sin(frac))
    if want_jumps:
        stats = _jump_stats(labels, n_sites, init_last=carry[0],
                            init_res=carry[1])
        acc["n_ij"] = acc["n_ij"] + stats["n_ij"]
        acc["lag_sum"] = acc["lag_sum"] + stats["lag_sum"]
        acc["res_sum"] = acc["res_sum"] + stats["res_sum"]
        acc["res_cnt"] = acc["res_cnt"] + stats["res_cnt"]
        carry = (stats["last_sites"], stats["last_res"])
    if max_mobile is not None:
        # multiple-occupancy detector, on device (SURVEY §3.2 guard): count
        # (frame, site) cells with more than max_mobile assigned ions
        B = labels.shape[0]
        per_fs = jnp.zeros((B, S + 1), jnp.int32).at[
            jnp.arange(B)[:, None],
            jnp.where(labels >= 0, labels, S)].add(1)
        acc["mo_viol"] = acc["mo_viol"] + jnp.sum(
            (per_fs[:, :S] > max_mobile).astype(jnp.int32))
    return carry, acc


class StreamingLandmarkAnalysis:
    """Parameters mirror :class:`LandmarkAnalysis` plus streaming controls:

    block_frames : frames per streamed device block.
    fit_frames : max frames subsampled for the clustering pass.
    fit_max_samples : cap on total (frame, ion) samples in the fit — the
        binding limit for many-ion systems (the landmark-vector matrix is
        ``samples x n_landmarks`` floats; 65536 x 9472 ≈ 2.5 GB).
    store_labels : optional path — labels spill to a memmapped ``.npy``
        of shape (n_frames, n_mobile).
    static_movement_threshold : max per-frame static-atom drift (Å) before
        :class:`StaticLatticeError` (None disables the on-device monitor).
    dynamic_lattice_mapping : follow lattice-site exchanges of static
        atoms mid-stream (slot→atom permutation rebuild, exactly as in
        :class:`LandmarkAnalysis`); the permutation rides the checkpoint.
    async_label_copy : start the label device→host copy eagerly (before
        the accumulator dispatch) when ``store_labels`` is set.  Off by
        default.
    pipeline_depth : blocks kept in flight by the optimistic run-ahead
        dispatcher (see the in-code note in ``run``): assign + accumulate
        are dispatched without host syncs and drift/labels are fetched
        when a block retires, ``pipeline_depth`` blocks later; a drift
        offender rolls the accumulators back to the pre-block snapshot
        and replays synchronously, bit-exactly.  Default 2; set 0 for the
        fully synchronous loop.  Results are bit-identical at any depth
        (tests/test_streaming.py pipeline-invariance tests).
    retire_group : in-flight blocks retired per BATCHED device→host
        fetch — one concatenated egress transfer plus one concatenated
        drift transfer per group, or one total with ``packed_retire``.
        The run-ahead window grows to ``pipeline_depth + retire_group``
        blocks; a drift offender rolls back to its own pre-block
        snapshot, so results stay bit-identical at any group size
        (invariance + engineered-hazard tests).  Default 1 (per-block
        retirement); ignored when ``pipeline_depth=0``.
    egress_pack12 : pack labels 4-per-3 int16 words (12 bits each,
        unknown −1 biased to 0) in the device→host egress stream — a
        further 25% off the label bytes below the int16 egress.  Active
        only when the int16 regime is (site count gates both: the pack
        needs K < 4096).  Bit-exact: labels are decoded on host before
        any consumer (memmap spill, exact-mode scan).  Default on.

    The defaults of these dispatch options have not been measured on a
    GPU yet (ROADMAP.md).  After ``run``, ``phase_times_`` holds the
    per-phase host wall time and ``kernel_path_`` the landmark path that
    ran: ``'tiled:triton'``, ``'tiled:plain'``, ``'tiled:interpret'``,
    ``'gather'`` or ``'dense'``.
    """

    def __init__(self, cutoff_midpoint=3.0, cutoff_steepness=4.0,
                 cutoff_shape="logistic",
                 minimum_site_occupancy=0.01, assignment_threshold=None,
                 clustering_params=None, block_frames=1024, fit_frames=8192,
                 fit_max_samples=65536,
                 store_labels=None, mesh=None, checkpoint_path=None,
                 checkpoint_every=64, max_mobile_per_site=1,
                 multiple_occupancy_action="warn",
                 static_movement_threshold=1.0,
                 dynamic_lattice_mapping=False, use_fused="auto",
                 async_label_copy=False, pipeline_depth=2,
                 retire_group=1, egress_pack12=True,
                 interpret=False, verbose=True):
        self.cutoff_midpoint = float(cutoff_midpoint)
        self.cutoff_steepness = float(cutoff_steepness)
        self.cutoff_shape = cutoff_shape
        self.minimum_site_occupancy = float(minimum_site_occupancy)
        self.clustering_params = dict(clustering_params or {})
        self.assignment_threshold = (
            self.clustering_params.get("assignment_threshold", 0.35)
            if assignment_threshold is None else float(assignment_threshold))
        self.block_frames = int(block_frames)
        self.fit_frames = int(fit_frames)
        self.fit_max_samples = int(fit_max_samples)
        self.store_labels = store_labels
        # multiple-occupancy guard (reference max_mobile_per_site semantics,
        # SURVEY §3.2): 'warn' | 'raise' (MultipleOccupancyError) | 'ignore'
        self.max_mobile_per_site = (
            None if max_mobile_per_site is None else int(max_mobile_per_site))
        if multiple_occupancy_action not in ("warn", "raise", "ignore"):
            raise ValueError("multiple_occupancy_action must be "
                             "'warn' | 'raise' | 'ignore'")
        self.multiple_occupancy_action = multiple_occupancy_action
        # static-lattice guards, mirroring LandmarkAnalysis: per-frame drift
        # is monitored on device; None disables.  With
        # dynamic_lattice_mapping the slot→atom permutation is rebuilt at
        # detected lattice-site exchanges instead of raising.
        self.static_movement_threshold = (
            None if static_movement_threshold is None
            else float(static_movement_threshold))
        self.dynamic_lattice_mapping = bool(dynamic_lattice_mapping)
        if self.dynamic_lattice_mapping and \
                self.static_movement_threshold is None:
            raise ValueError("dynamic_lattice_mapping needs a "
                             "static_movement_threshold")
        self.mesh = mesh  # optional 1-D frame mesh: blocks shard over it
        self.use_fused = use_fused  # 'auto' | True | False
        self.async_label_copy = bool(async_label_copy)
        self.pipeline_depth = int(pipeline_depth)
        # blocks retired per batched fetch in the run-ahead dispatcher
        # (see the class docstring); 1 = per-block retirement
        self.retire_group = max(1, int(retire_group))
        self.packed_retire = False  # opt-in: read drift from the packed
        # egress columns at retirement (one fetch instead of two)
        self.egress_int16 = "auto"  # 'auto' (site count < 2^15) | bool;
        # int16 label egress halves the device->host label stream
        # 12-bit label pack on top of int16 egress (a further 25% off the
        # label bytes; requires K < 4096 and the int16 regime — silently
        # inactive otherwise); bit-exact by the decode (labels are
        # reconstructed on host before any consumer).
        self.egress_pack12 = bool(egress_pack12)
        self.interpret = bool(interpret)  # Pallas interpret mode (CPU tests)
        self.spill_every = None  # None = auto epoch bound; tests override
        # mid-run checkpointing (SURVEY.md §6.4): every N blocks the device
        # accumulators + scan carry + cursor are snapshotted; an interrupted
        # run resumes from the snapshot bit-exactly
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.verbose = verbose
        self.n_sites_ = None
        self.kernel_path_ = None

    # -- pass 1 --------------------------------------------------------
    def fit_centers(self, sn: SiteNetwork, reader):
        n_frames = len(reader)
        mobile_idx = np.flatnonzero(sn.mobile_mask)
        # the SAMPLE budget binds for many-ion systems: every fit frame
        # contributes n_mobile landmark vectors of n_landmarks floats
        n_fit = min(self.fit_frames,
                    max(1, self.fit_max_samples // max(1, len(mobile_idx))))
        stride = max(1, -(-n_frames // n_fit))  # ceil: a HARD sample cap
        static_idx = np.flatnonzero(sn.static_mask)
        verts, vmask = sn.padded_vertices()
        cell = jnp.asarray(sn.structure.cell, jnp.float32)
        cell_inv = jnp.asarray(np.linalg.inv(sn.structure.cell), jnp.float32)

        # the fit pass must follow lattice-site exchanges too, or the
        # cluster centers are fit on corrupted landmark vectors for exactly
        # the trajectories dynamic_lattice_mapping targets
        perm = np.arange(len(static_idx))
        if self.dynamic_lattice_mapping:
            from sitator_tpu.landmark.analysis import LandmarkAnalysis
            from sitator_tpu.ops.pbc import PBCCalculator
            calc = PBCCalculator(sn.structure.cell)
            ref = np.asarray(sn.structure.positions[static_idx], np.float64)
            thr = self.static_movement_threshold

        # the fit pass needs landmark VECTORS (to cluster): the
        # lv-emitting tiled entry point, chosen by the same rule as pass 2
        use_fused = self.use_fused in ("auto", True)
        fit_basis = None
        kcell_fit = jnp.asarray(kernel_cell(sn.structure.cell))
        A = None
        if use_fused:
            from sitator_tpu.ops.landmark_mxu import prepare_engine_basis
            fit_basis = prepare_engine_basis(
                verts, vmask, sn.centers, sn.structure.cell,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape,
                static_ref=sn.structure.positions[static_idx],
                drift_budget=self.static_movement_threshold)
        if not use_fused:
            # dense membership matrix only when the dense branch runs
            A = lmops.vertex_membership_matrix(verts, vmask,
                                               len(static_idx))

        lvs = []
        B = 256
        sel = np.arange(0, n_frames, stride)
        for lo in range(0, len(sel), B):
            frames = np.stack([reader[int(i):int(i) + 1][0]
                               for i in sel[lo:lo + B]])
            static_np = frames[:, static_idx]
            if self.dynamic_lattice_mapping:
                static_np = static_np.copy()
                for b in range(len(static_np)):
                    d = calc.paired_distances(static_np[b][perm], ref)
                    if (d > thr).any():
                        new_perm, worst = \
                            LandmarkAnalysis._find_lattice_mapping(
                                static_np[b], perm, ref,
                                sn.structure.cell, thr)
                        if new_perm is None:
                            from sitator_tpu.util.errors import \
                                StaticLatticeError
                            raise StaticLatticeError(
                                "no consistent lattice mapping at "
                                f"subsampled frame {int(sel[lo + b])}: "
                                f"residual {worst:.3f} Å > threshold "
                                f"{thr} Å", frame=int(sel[lo + b]),
                                max_drift=worst)
                        perm = new_perm
                    static_np[b] = static_np[b][perm]
            mob_j = jnp.asarray(frames[:, mobile_idx], jnp.float32)
            stat_j = jnp.asarray(static_np, jnp.float32)
            if fit_basis is not None:
                from sitator_tpu.ops.landmark_mxu import mxu_landmark_blocks
                lv = mxu_landmark_blocks(
                    mob_j, stat_j, fit_basis, kcell_fit,
                    midpoint=self.cutoff_midpoint,
                    steepness=self.cutoff_steepness,
                    cutoff_shape=self.cutoff_shape,
                    interpret=self.interpret)
            elif use_fused:
                lv = _gather_lv(mob_j, stat_j, jnp.asarray(verts),
                                jnp.asarray(vmask), kcell_fit,
                                midpoint=self.cutoff_midpoint,
                                steepness=self.cutoff_steepness,
                                cutoff_shape=self.cutoff_shape)
            else:
                lv = lmops.landmark_vectors(
                    mob_j, stat_j, A, cell, cell_inv, self.cutoff_midpoint,
                    self.cutoff_steepness, cutoff_shape=self.cutoff_shape)
            lv_n, _ = lmops.normalize_landmark_vectors(lv)
            lvs.append(np.asarray(lv_n.reshape(-1, lv_n.shape[-1])))
        X = np.concatenate(lvs)
        p = {"clustering_threshold": 0.45, "k_max": 512, "n_refine_iters": 10,
             **self.clustering_params}
        min_samples = max(1, int(np.ceil(
            self.minimum_site_occupancy * len(sel))))
        res = dotprod_fit(jnp.asarray(X), k_max=p["k_max"],
                          cluster_threshold=p["clustering_threshold"],
                          min_samples=min_samples,
                          n_iters=p["n_refine_iters"])
        keep = np.asarray(res["active"])
        centers = np.asarray(res["centers"])[keep]
        if self.verbose:
            logger.info("streaming fit: %d sites from %d subsampled frames",
                        len(centers), len(sel))
        return centers

    # -- pass 2 --------------------------------------------------------
    def run(self, sn: SiteNetwork, trajectory, centers=None):
        """``trajectory``: a TrajectoryReader or (F, A, 3) array.  Returns
        an annotated SiteNetwork (the streaming result object)."""
        reader = (trajectory if hasattr(trajectory, "__getitem__")
                  and not isinstance(trajectory, np.ndarray)
                  else ArrayTrajectory(np.asarray(trajectory)))
        n_frames = len(reader)
        if centers is None:
            centers = self.fit_centers(sn, reader)
        K = len(centers)
        self.n_sites_ = K
        # per-phase host wall time of this run (observability; see _Phase)
        pt = self.phase_times_ = {}

        def ph(name):
            return _Phase(pt, name)

        _setup = _Phase(pt, "setup")   # pass-2 preamble: basis prep,
        _setup.__enter__()             # checkpoint probe, memmap create
        # observability: epochs routed through the exact host int64 jump
        # scan by the self-healing wrap protection (see set_mode below)
        self.exact_jump_epochs_ = 0

        mobile_idx = np.flatnonzero(sn.mobile_mask)
        static_idx = np.flatnonzero(sn.static_mask)
        n_mobile = len(mobile_idx)
        verts, vmask = sn.padded_vertices()
        cell_np = sn.structure.cell
        cell = jnp.asarray(cell_np, jnp.float32)
        cell_inv = jnp.asarray(np.linalg.inv(cell_np), jnp.float32)
        kcell = kernel_cell(cell_np)
        # tiled or gather path for any cell (with a mesh it runs per shard
        # under shard_map inside _assign_block); dense only when asked
        use_fused = self.use_fused in ("auto", True)
        centers_j = jnp.asarray(centers, jnp.float32)
        active = jnp.ones(K, bool)
        verts_j = jnp.asarray(verts)
        vmask_j = jnp.asarray(vmask)
        # path plan: the tiled lv stage when the basis shares vertices,
        # else the per-vertex gather path; dense only with use_fused=False
        kernel = "dense"
        mxu_preshift = False
        ref_u_j = jnp.zeros((1, 1, 3), jnp.float32)
        anchors_j = jnp.zeros((1, 3), jnp.float32)
        uidx_j = jnp.zeros((1, 1), jnp.int32)
        Am_j = jnp.zeros((1, 1, 1), jnp.float32)
        kill_j = jnp.zeros((1,), jnp.float32)
        if use_fused:
            kernel = "gather"
            from sitator_tpu.ops.landmark_mxu import (permute_centers,
                                                      prepare_engine_basis)
            # preshift exactness needs bounded static drift: the shared
            # gate ties its budget to the engine's own drift guard (and
            # disables it outright when the guard is off)
            basis = prepare_engine_basis(
                verts, vmask, sn.centers, cell_np,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape,
                static_ref=sn.structure.positions[static_idx],
                drift_budget=self.static_movement_threshold)
            if basis is not None:
                kernel = "tiled"
                uidx_j, Am_j, kill_j = (basis["uidx"], basis["A"],
                                        basis["kill"])
                mxu_preshift = bool(basis["preshift"])
                if mxu_preshift:
                    ref_u_j = basis["ref_u"]
                    anchors_j = basis["anchors"]
                centers_j = jnp.asarray(
                    permute_centers(centers, basis), jnp.float32)
        # the dense membership matrix only exists on the dense route — at
        # flagship scale it is ~n_static x n_landmarks x 4 B of pure dead
        # weight for the other paths
        A = (lmops.vertex_membership_matrix(verts, vmask, len(static_idx))
             if kernel == "dense" else jnp.zeros((1, 1), jnp.float32))
        self.kernel_path_ = (f"tiled:{lv_impl(self.interpret)}"
                             if kernel == "tiled" else kernel)

        start_lo = 0
        carry_np = (np.full((n_mobile,), -1, np.int64),
                    np.zeros((n_mobile,), np.int64))
        # static-lattice reference (slot positions) + slot→atom permutation
        static_ref_np = np.asarray(
            sn.structure.positions[static_idx], np.float64)
        static_ref_j = jnp.asarray(static_ref_np, jnp.float32)
        perm = np.arange(len(static_idx))
        n_remaps = 0

        def zero_acc():
            acc = {
                "occ": jnp.zeros((K + 1,), jnp.int32),
                "conf": jnp.zeros((K + 1,), jnp.float32),
                "cos": jnp.zeros((K + 1, 3), jnp.float32),
                "sin": jnp.zeros((K + 1, 3), jnp.float32),
                "n_ij": jnp.zeros((K, K), jnp.int32),
                "lag_sum": jnp.zeros((K, K), jnp.int32),
                "res_sum": jnp.zeros((K,), jnp.int32),
                "res_cnt": jnp.zeros((K,), jnp.int32),
            }
            if self.max_mobile_per_site is not None:
                acc["mo_viol"] = jnp.zeros((), jnp.int32)
            return acc

        # Device accumulators are int32/float32 for speed; to stay exact on
        # arbitrarily long runs (int32 wraps ≈4M frames in, fp32 addition
        # stalls ≈2^24 in) they are SPILLED into host int64/float64 totals
        # every `spill_every` blocks.  The epoch bound keeps every device
        # tally ≤ 2^26 — far from both failure modes.
        spill_every = self.spill_every or max(
            1, (1 << 26) // max(1, self.block_frames * n_mobile))
        host_acc = None  # lazily keyed off the first device acc
        acc = zero_acc()

        def spill(host, dev):
            dev = {k: np.asarray(v) for k, v in dev.items()}
            if host is None:
                host = {}
            for k, v in dev.items():
                if (v.dtype.kind in "iu"
                        and np.abs(v.astype(np.int64)).max(initial=0)
                        > (1 << 30)):
                    # BACKSTOP, should be unreachable: per-epoch counts are
                    # bounded ≤ 2^26 by spill_every, and the residence-
                    # weighted sums (lag_sum/res_sum) are bounded < 2^30 by
                    # set_mode's pre-epoch check (hazardous epochs route
                    # through the exact host int64 scan instead).
                    logger.warning(
                        "device accumulator %r unexpectedly neared int32 "
                        "range within one spill epoch — wrap-protection "
                        "invariant violated, please report", k)
                if k not in host:  # also covers legacy checkpoints
                    host[k] = np.zeros(v.shape,
                                       np.int64 if v.dtype.kind in "iu"
                                       else np.float64)
                host[k] += v
            return host

        # resume from a mid-run checkpoint if one exists
        import os
        ckpt = self.checkpoint_path
        if ckpt is not None and os.path.exists(ckpt):
            with np.load(ckpt) as d:
                if int(d["n_frames"]) != n_frames or int(d["K"]) != K:
                    raise ValueError("checkpoint does not match this run")
                start_lo = int(d["next_lo"])
                # carry_res may be int64 if the checkpoint was written in
                # the exact-residence regime; the mode decision below
                # (set_mode) re-chooses the representation soundly
                carry_np = (d["carry_last"].astype(np.int64),
                            d["carry_res"].astype(np.int64))
                if "perm" in d.files:
                    perm = d["perm"].copy()
                host_acc = {k[5:]: d[k].copy() for k in d.files
                            if k.startswith("hacc/")}
                if not host_acc:
                    # legacy checkpoint (device acc only): fold it in
                    host_acc = spill(None, {k[4:]: d[k] for k in d.files
                                            if k.startswith("acc/")})
            if self.verbose:
                logger.info("resuming streaming run at frame %d", start_lo)

        labels_out = None
        if self.store_labels is not None:
            mode = "r+" if (ckpt is not None and start_lo > 0
                            and os.path.exists(self.store_labels)) else "w+"
            labels_out = np.lib.format.open_memmap(
                self.store_labels, mode=mode, dtype=np.int32,
                shape=(n_frames, n_mobile))

        # --- self-healing int32 wrap protection for jump tallies --------
        # The residence-weighted device tallies (lag_sum/res_sum) are
        # int32; an ion carrying a huge open residence (idle for ~2^30+
        # frames) that finally jumps could wrap them WITHIN one epoch — a
        # hazard more frequent spilling cannot remove (the carried
        # residence closes in one block regardless).  Sound bound: over
        # one epoch, any single accumulator cell's increment is at most
        # Σ_i max(carry_res_i, 0) + 2·M·B·spill_every (each ion's open
        # residence plus disjoint in-epoch runs).  At every spill/resume
        # boundary set_mode() evaluates it: when it reaches 2^30 (2×
        # safety margin below int32 range, aligned with spill()'s backstop
        # warning threshold) the NEXT epoch's jump statistics are computed
        # on the host by the exact int64 scan that jump_stats_exact uses
        # (the device keeps the bounded occ/conf/center accumulators);
        # once the bound clears, the fast on-device scan resumes.  Exact
        # at any frame count, no user action.
        exact_mode = False
        exact_carry = None  # (last, res) in host int64 while exact
        carry = None        # (last, res) on device int32 while fast
        carry_dummy = (jnp.zeros((n_mobile,), jnp.int32),
                       jnp.zeros((n_mobile,), jnp.int32))

        def set_mode(c_np):
            nonlocal exact_mode, exact_carry, carry
            bound = int(np.maximum(c_np[1], 0).sum()) \
                + 2 * n_mobile * self.block_frames * spill_every
            hazardous = bound >= (1 << 30)
            if hazardous:
                self.exact_jump_epochs_ += 1
                if not exact_mode and self.verbose:
                    logger.info(
                        "carried residences total %.2e frames: routing jump "
                        "statistics through the exact host int64 scan until "
                        "the bound clears", float(np.maximum(c_np[1], 0)
                                                  .sum()))
                exact_carry = (c_np[0].astype(np.int64),
                               c_np[1].astype(np.int64))
                carry = None
            else:
                if exact_mode and self.verbose:
                    logger.info("carried-residence bound cleared: resuming "
                                "on-device jump statistics")
                # bound < 2^30 implies every carried residence fits int32
                carry = (jnp.asarray(c_np[0].astype(np.int32)),
                         jnp.asarray(c_np[1].astype(np.int32)))
                exact_carry = None
            exact_mode = hazardous

        def current_carry_np():
            return (exact_carry if exact_mode else
                    (np.asarray(carry[0]).astype(np.int64),
                     np.asarray(carry[1]).astype(np.int64)))

        # the fast path's `valid` masks take only two shapes (full block,
        # partial tail) — memoize their device uploads.  The slow path can
        # produce arbitrary segment masks (drift gating / remap replay),
        # so the cache is capped: beyond it, upload fresh and let the
        # buffer be collected.
        valid_dev_cache = {}

        def valid_dev(valid_np):
            key = valid_np.tobytes()
            v = valid_dev_cache.get(key)
            if v is None:
                v = jnp.asarray(valid_np)
                if len(valid_dev_cache) < 16:
                    valid_dev_cache[key] = v
            return v

        def split_decode_egress(arr, box):
            """Decode one fetched egress slab into ``box``: split off the
            packed-drift trailer columns (keyed on the label width
            ``eg_w``), un-pack 12-bit labels if the pack is active.
            Shared by the per-block (:func:`fetch_labels`) and grouped
            (:func:`retire_many`) fetch paths — the egress LAYOUT has a
            single decoder."""
            if arr.shape[1] > eg_w:
                box["drift"] = (arr[:, eg_w:eg_w + 2]
                                .copy().view(np.float32)[:, 0])
                arr = arr[:, :eg_w]
            if assign_kw["egress_pack12"]:
                arr = _unpack12(arr, n_mobile)
            box["np"] = arr

        def fetch_labels(box):
            """Host copy of one assignment's egress labels, fetched at most
            once per assignment (``box['dev']`` is the int16 egress array;
            ``box['np']`` caches the transfer).  When the per-frame drift
            rode along as trailing bitcast columns, it is split off into
            ``box['drift']``."""
            if box["np"] is None:
                with ph("labels_fetch"):
                    arr = np.asarray(box["dev"])
                split_decode_egress(arr, box)
            return box["np"]

        def fold(valid_np, labels, confs, mobile, box):
            """Fold the valid frames of one block's assignment into the
            accumulators, by whichever jump-statistics route the current
            mode dictates."""
            nonlocal carry, acc, exact_carry, host_acc
            if not exact_mode:
                with ph("dispatch_fold"):
                    carry, acc = _accum_block(
                        labels, confs, mobile, cell_inv,
                        valid_dev(valid_np), carry, acc, n_sites=K,
                        max_mobile=self.max_mobile_per_site)
                return
            with ph("dispatch_fold"):
                _, acc = _accum_block(
                    labels, confs, mobile, cell_inv,
                    valid_dev(valid_np), carry_dummy, acc, n_sites=K,
                    max_mobile=self.max_mobile_per_site, want_jumps=False)
            lbl = np.where(valid_np[:, None], fetch_labels(box), -1)
            with ph("host_jump_scan"):
                dev, last64, res64 = _jump_stats_block_int64(
                    lbl, K, exact_carry[0], exact_carry[1], "persist")
            exact_carry = (last64, res64)
            if host_acc is None:
                host_acc = {}
            for k in ("n_ij", "lag_sum", "res_sum", "res_cnt"):
                if k not in host_acc:
                    host_acc[k] = np.zeros(dev[k].shape, np.int64)
                host_acc[k] += dev[k]

        set_mode(carry_np)

        sharding = None
        if self.mesh is not None:
            from sitator_tpu.parallel.mesh import frame_sharding
            sharding = frame_sharding(self.mesh)
            if self.block_frames % self.mesh.devices.size:
                raise ValueError(
                    "block_frames must be a multiple of the mesh size")

        B = self.block_frames
        blocks_done = 0
        from sitator_tpu.util.progress import get_progress_bar
        feeder = get_progress_bar(
            ChunkedFeeder(reader, B, start=start_lo), enabled=self.verbose,
            total=-(-(n_frames - start_lo) // B), desc="streaming",
            unit="block")
        thr_drift = self.static_movement_threshold
        assign_kw = dict(
            kernel=kernel, midpoint=self.cutoff_midpoint,
            steepness=self.cutoff_steepness,
            threshold=self.assignment_threshold,
            cutoff_shape=self.cutoff_shape, mesh=self.mesh,
            interpret=self.interpret, mxu_preshift=mxu_preshift,
            want_drift=thr_drift is not None,
            # int16 label egress halves the engine's one large
            # device->host stream; any practical site count fits.  The
            # K guard binds even when the measurement hook forces True —
            # site indices >= 2^15 must never wrap
            egress_int16=bool(self.egress_int16) and K < (1 << 15))
        # 12-bit pack rides on top of the int16 egress: biased labels
        # (unknown −1 → 0) need K+1 ≤ 4096 values, so the guard binds
        # even when the measurement hook forces the pack on
        assign_kw["egress_pack12"] = (bool(self.egress_pack12)
                                      and assign_kw["egress_int16"]
                                      and K < 4096)
        # label columns in the egress array (before any packed-drift
        # trailer) — the split/decode sites below key off this width
        eg_w = (pack12_width(n_mobile) if assign_kw["egress_pack12"]
                else n_mobile)
        # ONE retirement fetch per block (opt-in packed_retire): with
        # labels spilling anyway and the drift guard on, packing drift
        # into the egress columns makes the separate 2 KB drift fetch
        # (and its transport round trip) unnecessary in the pipelined
        # path.  Inapplicable without a label memmap (the egress array
        # is then never fetched).
        pack_drift = (assign_kw["egress_int16"] and assign_kw["want_drift"]
                      and labels_out is not None
                      and bool(self.packed_retire))
        assign_kw["pack_drift"] = pack_drift

        def write_labels(lo, a, b, box):
            """Spill frames [a, b) of a block's labels to the memmap (the
            int32 memmap upcasts the int16 egress on assignment)."""
            if labels_out is None:
                return
            lab = fetch_labels(box)
            with ph("labels_memmap_write"):
                labels_out[lo + a:lo + b] = lab[a:b]

        def upload_static(block):
            with ph("upload"):
                static_np = block[:, static_idx]
                if self.dynamic_lattice_mapping:
                    static_np = static_np[:, perm]
                static = jnp.asarray(static_np, jnp.float32)
                if sharding is not None:
                    static = jax.device_put(static, sharding)
            return static

        def assign(mobile, static):
            with ph("dispatch_assign"):
                labels, confs, drift, labels_eg = _assign_block(
                    mobile, static, verts_j, vmask_j, A, cell, cell_inv,
                    kcell, centers_j, active, uidx_j, Am_j, kill_j,
                    ref_u_j, anchors_j, static_ref_j, **assign_kw)
            if labels_out is not None and self.async_label_copy:
                # opt-in: start the label device->host copy NOW so it
                # overlaps the accumulator dispatches
                try:
                    labels_eg.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    pass
            return labels, confs, drift, labels_eg

        def process_block_slow(lo, block, nb, mobile, pre=None,
                               pre_box=None):
            """The fully-synchronous per-block path: per-frame drift
            gating, lattice remapping, partial folds.  ``pre`` reuses an
            existing assignment (labels, confs, drift, labels_eg) for the
            block — valid only while ``perm`` is unchanged since it was
            made."""
            nonlocal perm, n_remaps
            processed = 0
            last_remap = (-1, 0)
            drift_f = None
            labels = confs = None
            box = pre_box if pre_box is not None else \
                {"np": None, "dev": None}
            if pre is not None:
                labels, confs, drift, labels_eg = pre
                if box["dev"] is None:
                    box["dev"] = labels_eg
                if thr_drift is not None:
                    with ph("drift_fetch"):
                        drift_f = np.asarray(drift)[:nb]
            need_assign = pre is None
            while processed < nb:
                if need_assign:
                    # (re)assign the whole block — only needed on entry
                    # and after a slot→atom permutation change;
                    # grazed-frame accepts reuse the existing assignment
                    labels, confs, drift, labels_eg = assign(
                        mobile, upload_static(block))
                    # labels are fetched lazily AFTER the first
                    # accumulator dispatch (the transfer then overlaps
                    # the accum compute), once per assignment (remap
                    # segments slice the host copy)
                    box = {"np": None, "dev": labels_eg}
                    if thr_drift is not None:
                        with ph("drift_fetch"):
                            drift_f = np.asarray(drift)[:nb]
                    need_assign = False
                stop = nb
                if thr_drift is not None:
                    off = np.flatnonzero(drift_f[processed:] > thr_drift)
                    if len(off):
                        if not self.dynamic_lattice_mapping:
                            from sitator_tpu.util.errors import \
                                StaticLatticeError
                            raise StaticLatticeError(
                                f"a static-lattice atom drifted "
                                f"{float(drift_f[processed + off[0]]):.3f} Å "
                                f"(> threshold {thr_drift} Å) at frame "
                                f"{lo + processed + int(off[0])}; see "
                                "dynamic_lattice_mapping for "
                                "site-exchanging lattices",
                                frame=lo + processed + int(off[0]))
                        stop = processed + int(off[0])
                if stop > processed:
                    valid = np.zeros(B, bool)
                    valid[processed:stop] = True
                    fold(valid, labels, confs, mobile, box)
                    write_labels(lo, processed, stop, box)
                if stop < nb:
                    # per-frame retry guard (mirrors LandmarkAnalysis): a
                    # few remap attempts are allowed at one frame, but any
                    # progress resets the count — a block may legitimately
                    # contain many distinct exchange events
                    if lo + stop == last_remap[0]:
                        if last_remap[1] >= 3:
                            from sitator_tpu.util.errors import \
                                StaticLatticeError
                            raise StaticLatticeError(
                                "lattice remapping did not converge at "
                                f"frame {lo + stop}", frame=lo + stop)
                        last_remap = (lo + stop, last_remap[1] + 1)
                    else:
                        last_remap = (lo + stop, 1)
                    from sitator_tpu.landmark.analysis import \
                        LandmarkAnalysis
                    new_perm, worst = LandmarkAnalysis._find_lattice_mapping(
                        block[stop, static_idx], perm, static_ref_np,
                        cell_np, thr_drift)
                    if new_perm is None:
                        from sitator_tpu.util.errors import \
                            StaticLatticeError
                        raise StaticLatticeError(
                            f"no consistent lattice mapping at frame "
                            f"{lo + stop}: residual {worst:.3f} Å > "
                            f"threshold {thr_drift} Å", frame=lo + stop,
                            max_drift=worst)
                    if np.array_equal(new_perm, perm):
                        # the device's f32 drift grazed the threshold but
                        # the f64 check finds no offenders: the frame is
                        # valid under the current mapping — accept it and
                        # move on (prevents a no-progress remap loop); the
                        # block's assignment stays valid (perm unchanged),
                        # so no recompute happens on the next iteration
                        valid = np.zeros(B, bool)
                        valid[stop] = True
                        fold(valid, labels, confs, mobile, box)
                        write_labels(lo, stop, stop + 1, box)
                        processed = stop + 1
                        continue
                    if self.verbose:
                        logger.info(
                            "frame %d: lattice site exchange — remapped %d "
                            "slots (max residual %.3f Å)", lo + stop,
                            int((new_perm != perm).sum()), worst)
                    perm = new_perm
                    n_remaps += 1
                    need_assign = True
                processed = stop

        # --- optimistic run-ahead (the dispatch pipeline) ---------------
        # Per block the synchronous path costs two dispatch round-trips
        # plus a blocking drift fetch BETWEEN them.  The fast path
        # instead dispatches assign + whole-block accumulate immediately
        # (device-to-device carry, no host sync) and keeps up to
        # ``pipeline_depth`` blocks in flight; drift/labels are fetched
        # when a block RETIRES, well after its compute finished.
        # Exactness: the accumulate is optimistic — before it, the
        # (carry, acc) references are snapshotted (free: jax arrays are
        # immutable), and if retirement finds a drift offender the
        # snapshot is restored and the offending block and every later
        # in-flight block are re-processed through the synchronous path,
        # which reproduces the never-pipelined behavior bit-for-bit
        # (same perm, same kernels, same folds).  Spills/checkpoints
        # drain the window first, so no optimistic state ever reaches
        # the exact host totals or a snapshot.
        window = []
        W = max(0, int(self.pipeline_depth))

        G = max(1, int(self.retire_group)) if W else 1

        def retire_many(g):
            """Retire the ``g`` oldest in-flight blocks with BATCHED
            device→host fetches: one concatenated egress transfer (plus
            one concatenated drift transfer unless packed) per group
            instead of per block, so the fixed per-transfer cost is paid
            once per group.  Bit-exact vs ``g`` sequential
            retirements: drift is checked oldest-first and an offender
            at group index ``i`` rolls the accumulators back to ITS
            pre-block snapshot and replays it and every later in-flight
            block through the synchronous path."""
            nonlocal carry, acc
            entries = window[:g]
            del window[:g]
            boxes = [{"np": None, "dev": e["labels_eg"]} for e in entries]
            need_packed = thr_drift is not None and pack_drift
            if len(entries) > 1 and (labels_out is not None or need_packed):
                # one transfer for the whole group's egress (drift rides
                # in the trailing columns on the packed path)
                with ph("labels_fetch"):
                    cat = np.asarray(jnp.concatenate(
                        [e["labels_eg"] for e in entries]))
                rows = entries[0]["labels_eg"].shape[0]
                for i, box in enumerate(boxes):
                    split_decode_egress(cat[i * rows:(i + 1) * rows], box)
            off_at = None
            if thr_drift is not None:
                if pack_drift:
                    if boxes[0]["np"] is None:     # g == 1: direct fetch
                        fetch_labels(boxes[0])
                    drifts = [b["drift"][:e["nb"]]
                              for b, e in zip(boxes, entries)]
                else:
                    with ph("drift_fetch"):
                        dcat = (np.asarray(entries[0]["drift"])
                                if len(entries) == 1
                                else np.asarray(jnp.concatenate(
                                    [e["drift"] for e in entries])))
                    rows = entries[0]["drift"].shape[0]
                    drifts = [dcat[i * rows:i * rows + e["nb"]]
                              for i, e in enumerate(entries)]
                for i, dr in enumerate(drifts):
                    if (dr > thr_drift).any():
                        off_at = i
                        break
            if off_at is None:
                for e, box in zip(entries, boxes):
                    write_labels(e["lo"], 0, e["nb"], box)
                return
            # rollback: blocks before the offender passed the guard and
            # keep their (already applied) folds — spill their labels;
            # restore the offender's pre-block accumulator snapshot and
            # replay it + every later in-flight block synchronously
            # (raises StaticLatticeError or remaps, exactly like the
            # unpipelined engine)
            e = entries[off_at]
            carry, acc = e["carry0"], e["acc0"]
            redo = entries[off_at:] + window[:]
            window.clear()
            for e2, b2 in zip(entries[:off_at], boxes[:off_at]):
                write_labels(e2["lo"], 0, e2["nb"], b2)
            for i, r in enumerate(redo):
                # the offending block's assignment predates any remap,
                # so it may be reused (pre); later blocks must
                # re-assign under the updated permutation
                process_block_slow(
                    r["lo"], r["block"], r["nb"], r["mobile"],
                    pre=(r["labels"], r["confs"], r["drift"],
                         r["labels_eg"]) if i == 0 else None,
                    pre_box=boxes[off_at] if i == 0 else None)

        def drain():
            while window:
                retire_many(min(G, len(window)))

        _setup.__exit__()
        for lo, block in _timed_iter(feeder, pt, "feeder"):
            nb = len(block)
            if nb < B:  # pad to the compiled block shape (frames masked out)
                from sitator_tpu.parallel.mesh import pad_frames
                block, _ = pad_frames(block, B)
            with ph("upload"):
                mobile = jnp.asarray(block[:, mobile_idx], jnp.float32)
                if sharding is not None:
                    mobile = jax.device_put(mobile, sharding)
            if W == 0 or exact_mode:
                # exact mode folds through the host int64 scan (a sync
                # per block anyway) — run synchronously
                drain()
                process_block_slow(lo, block, nb, mobile)
            else:
                carry0, acc0 = carry, acc
                labels, confs, drift, labels_eg = assign(
                    mobile, upload_static(block))
                valid = np.zeros(B, bool)
                valid[:nb] = True
                fold(valid, labels, confs, mobile,
                     {"np": None, "dev": labels_eg})
                window.append(dict(
                    lo=lo, nb=nb, block=block, mobile=mobile,
                    labels=labels, confs=confs, drift=drift,
                    labels_eg=labels_eg, carry0=carry0, acc0=acc0))
                while len(window) >= W + G:
                    retire_many(G)
            blocks_done += 1
            do_ckpt = (ckpt is not None
                       and blocks_done % self.checkpoint_every == 0)
            if do_ckpt or blocks_done % spill_every == 0:
                # fold the device epoch into the exact host totals; a
                # checkpoint always snapshots fully-spilled state.  Then
                # re-evaluate the sound carried-residence bound for the
                # NEXT epoch and (re)choose fast vs exact jump
                # accumulation — the self-healing wrap protection.
                # (drain first: optimistic in-flight blocks must retire —
                # or roll back — before their stats can be spilled)
                drain()
                with ph("epoch_spill"):
                    host_acc = spill(host_acc, acc)
                    acc = zero_acc()
                    set_mode(current_carry_np())
            if do_ckpt:
                with ph("checkpoint"):
                    self._save_checkpoint(
                        ckpt, n_frames, K, lo + nb,
                        exact_carry if exact_mode else carry, host_acc,
                        perm)

        drain()
        with ph("epoch_spill"):
            host_acc = spill(host_acc, acc)
        if n_remaps and self.verbose:
            logger.info("dynamic lattice mapping: %d slot→atom remaps",
                        n_remaps)
        self.lattice_mapping_ = perm if self.dynamic_lattice_mapping else None
        if ckpt is not None and os.path.exists(ckpt):
            os.remove(ckpt)  # run completed; checkpoint no longer needed
        self._check_multiple_occupancy(host_acc, n_frames)
        with ph("finalize"):
            out = self._finalize(sn, centers, host_acc, n_frames,
                                 labels_out)
        return out

    def _check_multiple_occupancy(self, host_acc, n_frames):
        n_viol = int(host_acc.get("mo_viol", 0))
        if n_viol == 0 or self.multiple_occupancy_action == "ignore":
            return
        msg = (f"{n_viol} (frame, site) occupancies exceed "
               f"max_mobile_per_site={self.max_mobile_per_site} over "
               f"{n_frames} frames — sites may be under-resolved")
        if self.multiple_occupancy_action == "raise":
            from sitator_tpu.util.errors import MultipleOccupancyError
            raise MultipleOccupancyError(msg, count=n_viol)
        logger.warning(msg)

    # -- streaming post-merge -------------------------------------------
    @staticmethod
    def merge_network(sn, inflation=2.0, distance_threshold=3.0,
                      verbose=True):
        """Merge over-split sites of a *streamed* result network using its
        accumulated ``n_ij`` (MCL on the jump graph, like
        ``MergeSitesByDynamics``) — but at the statistics level, since the
        label matrix may never be memory-resident: hop counts and
        occupancy-style attributes are group-summed; intra-group hops
        (flickers between split halves) drop out of ``n_ij``.

        Returns ``(merged_network, remap)`` where ``remap[j]`` is the new
        index of old site ``j`` — apply to spilled labels lazily.

        Note: residence-style attributes cannot be exactly reconstituted
        from summed statistics (a flicker inside a merged group should have
        been one continuous residence); they are dropped.  Re-run
        JumpAnalysis on remapped labels where exact residences matter.
        """
        from sitator_tpu.ops.mcl import markov_cluster
        from sitator_tpu.ops.pbc import PBCCalculator
        from sitator_tpu.network.merging import _components

        n_ij = np.asarray(sn.n_ij, dtype=np.float64)
        T = n_ij + n_ij.T
        T[np.diag_indices_from(T)] += np.maximum(T.max(axis=1), 1.0)
        groups = markov_cluster(T, inflation=inflation)
        calc = PBCCalculator(sn.structure.cell)
        occ = np.asarray(sn.occupancies)

        # distance guard: single-linkage split within each group
        final = []
        for g in groups:
            g = np.asarray(g)
            if len(g) == 1 or distance_threshold is None:
                final.append(g)
                continue
            d = calc.pairwise_distances(sn.centers[g])
            final.extend(g[c] for c in _components(d <= distance_threshold))
        final.sort(key=lambda g: int(g.min()))

        S = sn.n_sites
        remap = np.empty(S, dtype=np.int32)
        for k, g in enumerate(final):
            remap[g] = k
        K2 = len(final)
        centers = np.empty((K2, 3))
        for k, g in enumerate(final):
            w = occ[g]
            centers[k] = calc.average(sn.centers[g],
                                      w if w.sum() > 0 else None)
        n_ij2 = np.zeros((K2, K2), dtype=np.int64)
        idx_i = np.broadcast_to(remap[:, None], (S, S))
        idx_j = np.broadcast_to(remap[None, :], (S, S))
        np.add.at(n_ij2, (idx_i, idx_j), n_ij.astype(np.int64))
        np.fill_diagonal(n_ij2, 0)  # intra-group hops were flickers
        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = centers
        out.add_site_attribute("occupancies",
                               np.bincount(remap, weights=occ,
                                           minlength=K2))
        out.add_edge_attribute("n_ij", n_ij2)
        row = n_ij2.sum(1, keepdims=True)
        out.add_edge_attribute(
            "p_ij", np.where(row > 0, n_ij2 / np.maximum(row, 1), 0.0))
        if verbose:
            logger.info("merge_network: %d -> %d sites, %d -> %d jumps",
                        S, K2, int(n_ij.sum()), int(n_ij2.sum()))
        return out, remap

    @staticmethod
    def _save_checkpoint(path, n_frames, K, next_lo, carry, host_acc,
                         perm=None):
        """Snapshot fully-spilled state: exact int64/float64 host totals,
        the jump-scan carry, and the lattice slot→atom permutation.
        Written atomically."""
        import os
        tmp = path + ".tmp"
        extra = {} if perm is None else {"perm": np.asarray(perm)}
        with open(tmp, "wb") as f:
            np.savez(f, n_frames=n_frames, K=K, next_lo=next_lo,
                     carry_last=np.asarray(carry[0]),
                     carry_res=np.asarray(carry[1]), **extra,
                     **{f"hacc/{k}": np.asarray(v)
                        for k, v in host_acc.items()})
        os.replace(tmp, path)  # atomic: a crash never corrupts the ckpt

    def _finalize(self, sn, centers, acc, n_frames, labels_out):
        K = len(centers)
        acc = {k: np.asarray(v) for k, v in acc.items()}
        occ = acc["occ"][:K].astype(np.float64)
        # toroidal mean -> fractional coords -> cartesian
        theta = np.arctan2(acc["sin"][:K], acc["cos"][:K])
        frac = (theta / (2 * np.pi)) % 1.0
        site_centers = frac @ sn.structure.cell

        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = site_centers
        out.add_site_attribute("occupancies", occ / n_frames)
        n_ij = acc["n_ij"].astype(np.int64)
        out.add_edge_attribute("n_ij", n_ij)
        row = n_ij.sum(1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            out.add_edge_attribute(
                "p_ij", np.where(row > 0, n_ij / np.maximum(row, 1), 0.0))
            out.add_edge_attribute(
                "jump_lag", np.where(n_ij > 0,
                                     acc["lag_sum"] / np.maximum(n_ij, 1),
                                     np.nan))
            out.add_site_attribute(
                "residence_times",
                np.where(acc["res_cnt"] > 0,
                         acc["res_sum"] / np.maximum(acc["res_cnt"], 1),
                         np.nan))
        out.add_site_attribute("total_corrected_residences",
                               acc["occ"][:K].astype(np.int64))
        self.labels_ = labels_out
        if self.verbose:
            logger.info("streaming run: %d frames, %d sites, %d jumps",
                        n_frames, K, int(n_ij.sum()))
        return out
