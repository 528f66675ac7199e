"""``LandmarkAnalysis`` — the core engine orchestrator (L4).

Reference parity: ``sitator/landmark/LandmarkAnalysis.py`` (SURVEY.md §3.2,
call stack §4.1).  The pipeline: static-lattice drift check → landmark
vectors (tiled lv stage, :mod:`sitator_tpu.ops.landmark_mxu`) → peak
evening → normalization → pluggable clustering → occupancy filtering →
PBC-aware site centers → :class:`SiteTrajectory`.

Execution notes: frames are processed in fixed-size blocks through a single
jitted block function (static shapes; last block padded), so the same code
path serves one device and, via ``sitator_tpu.parallel``, frame-sharded
multi-device meshes.  The landmark basis is the ``(n_static, n_landmarks)``
membership matrix of the seed network's Voronoi vertex sets.
"""
from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.core.sitenet import SiteNetwork
from sitator_tpu.core.sitetraj import SiteTrajectory
from sitator_tpu.landmark.cluster import get_backend
from sitator_tpu.ops import landmark as lmops
from sitator_tpu.ops.kernel_common import lv_impl
from sitator_tpu.ops.pbc import PBCCalculator, kernel_cell
from sitator_tpu.util.errors import (
    InsufficientSitesError,
    StaticLatticeError,
    ZeroLandmarkError,
)

logger = logging.getLogger(__name__)


class LandmarkAnalysis:
    """Unsupervised landmark analysis: discover sites and assign every
    (frame, mobile ion) to one.

    Parameters (constructor-kwargs API, reference parity — SURVEY.md §6.6):

    cutoff_midpoint, cutoff_steepness : logistic landmark cutoff ``c(d) =
        1/(1+exp(steepness (d - midpoint)))`` (Å).  Calibration constants —
        the reference defaults are unverified (SURVEY.md §0 item 4).
    minimum_site_occupancy : drop discovered sites occupied less than this
        fraction of frames.
    peak_evening : 'none' | 'clip' — flatten landmark-vector peaks before
        clustering.
    weighted_site_positions : weight site centers by assignment confidence.
    check_for_zero_landmarks : raise :class:`ZeroLandmarkError` if any ion
        sees no landmark (else warn).
    static_movement_threshold : max drift (Å) of any static atom before
        :class:`StaticLatticeError`.
    dynamic_lattice_mapping : follow static atoms that EXCHANGE lattice
        sites: vertex indices address lattice slots, and the slot→atom
        permutation is rebuilt (min-image Hungarian match of displaced
        atoms to vacated slots) at each detected exchange;
        :class:`StaticLatticeError` is raised only when no consistent
        mapping exists.  The final map is exposed as ``lattice_mapping_``.
    max_mobile_per_site : flag frames where more ions than this share a site.
    multiple_occupancy_action : 'warn' (default) | 'raise'
        (:class:`MultipleOccupancyError`) | 'ignore'.
    clustering_algorithm : backend name ('dotprod') or module.
    clustering_params : dict passed to the backend.
    batch_frames : frames per device block.
    """

    def __init__(self,
                 cutoff_midpoint=3.0,
                 cutoff_steepness=4.0,
                 cutoff_shape="logistic",
                 minimum_site_occupancy=0.01,
                 peak_evening="none",
                 weighted_site_positions=True,
                 check_for_zero_landmarks=True,
                 static_movement_threshold=1.0,
                 max_mobile_per_site=1,
                 multiple_occupancy_action="warn",
                 dynamic_lattice_mapping=False,
                 clustering_algorithm="dotprod",
                 clustering_params=None,
                 batch_frames=256,
                 mesh=None,
                 use_fused="auto",
                 interpret=False,
                 verbose=True):
        # use_fused: 'auto' / True (tiled lv stage when the basis shares
        # vertices, plain gather path otherwise) | False (dense XLA path).
        # The reference contract exposes .landmark_vectors, so this engine
        # uses the lv-EMITTING entry point (mxu_landmark_blocks).  The
        # path that ran is recorded in ``kernel_path_``.
        self.use_fused = use_fused
        self.interpret = bool(interpret)
        # dynamic_lattice_mapping (reference ⚠ feature, SURVEY.md §3.2):
        # vertex indices address lattice SLOTS; a slot→atom permutation is
        # rebuilt whenever static atoms exchange lattice sites, so the
        # landmark basis follows the lattice.  StaticLatticeError is raised
        # only when no consistent mapping exists.
        self.dynamic_lattice_mapping = bool(dynamic_lattice_mapping)
        self.cutoff_midpoint = float(cutoff_midpoint)
        self.cutoff_steepness = float(cutoff_steepness)
        self.cutoff_shape = cutoff_shape
        self.minimum_site_occupancy = float(minimum_site_occupancy)
        self.peak_evening = peak_evening
        self.weighted_site_positions = bool(weighted_site_positions)
        self.check_for_zero_landmarks = bool(check_for_zero_landmarks)
        self.static_movement_threshold = float(static_movement_threshold)
        self.max_mobile_per_site = max_mobile_per_site
        if multiple_occupancy_action not in ("warn", "raise", "ignore"):
            raise ValueError("multiple_occupancy_action must be "
                             "'warn' | 'raise' | 'ignore'")
        self.multiple_occupancy_action = multiple_occupancy_action
        self.clustering_algorithm = clustering_algorithm
        self.clustering_params = dict(clustering_params or {})
        self.batch_frames = int(batch_frames)
        self.mesh = mesh  # optional 1-D frame mesh: blocks shard over it
        self.verbose = verbose
        self._landmark_vectors = None
        self._landmark_dimension = None
        self.kernel_path_ = None

    # reference parity: exposed after run()
    @property
    def landmark_vectors(self):
        if self._landmark_vectors is None:
            raise ValueError("LandmarkAnalysis has not been run")
        return self._landmark_vectors

    @property
    def landmark_dimension(self):
        if self._landmark_dimension is None:
            raise ValueError("LandmarkAnalysis has not been run")
        return self._landmark_dimension

    def run(self, sn: SiteNetwork, frames) -> SiteTrajectory:
        frames = np.asarray(frames)
        if frames.ndim != 3 or frames.shape[1] != sn.structure.n_atoms \
                or frames.shape[2] != 3:
            raise ValueError("frames must be (n_frames, n_atoms, 3)")
        if not sn.has_vertices:
            raise ValueError(
                "input SiteNetwork has no vertices — run VoronoiSiteGenerator"
                " (or provide landmark polyhedra) first")
        n_frames = frames.shape[0]
        mobile_idx = np.flatnonzero(sn.mobile_mask)
        static_idx = np.flatnonzero(sn.static_mask)
        n_mobile, n_static = len(mobile_idx), len(static_idx)
        n_landmarks = sn.n_sites
        self._landmark_dimension = n_landmarks

        cell = sn.structure.cell.astype(np.float32)
        cell_j = jnp.asarray(cell)
        cell_inv_j = jnp.asarray(np.linalg.inv(sn.structure.cell),
                                 dtype=jnp.float32)
        verts, vmask = sn.padded_vertices()
        static_ref = jnp.asarray(
            sn.structure.positions[static_idx], dtype=jnp.float32)

        mode = self.peak_evening

        # one backend-neutral choice (shared with the streaming engine and
        # the SPMD pipeline): the tiled lv stage wherever the basis shares
        # vertices, the plain gather path otherwise; the dense XLA
        # contraction only when asked for (use_fused=False)
        use_fused = self.use_fused in ("auto", True)
        mxu_basis = None
        kcell = jnp.asarray(kernel_cell(sn.structure.cell))
        if use_fused:
            from sitator_tpu.ops.landmark_mxu import prepare_engine_basis
            mxu_basis = prepare_engine_basis(
                verts, vmask, sn.centers, sn.structure.cell,
                midpoint=self.cutoff_midpoint,
                steepness=self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape,
                static_ref=sn.structure.positions[static_idx],
                drift_budget=self.static_movement_threshold)
        if mxu_basis is not None:
            self.kernel_path_ = "tiled:" + lv_impl(self.interpret)
            # basis arrays travel as jit ARGUMENTS, not closure constants
            barrs = (mxu_basis["uidx"], mxu_basis["A"], mxu_basis["kill"],
                     mxu_basis["ref_u"] if mxu_basis["preshift"]
                     else jnp.zeros((mxu_basis["n_st"], mxu_basis["UP"], 3),
                                    jnp.float32),
                     mxu_basis["anchors"] if mxu_basis["preshift"]
                     else jnp.zeros((mxu_basis["n_st"], 3), jnp.float32),
                     mxu_basis["inv_order"], kcell)
            bstat = {k: mxu_basis[k] for k in
                     ("s_tile", "n_st", "UP", "preshift")}
        elif use_fused:
            self.kernel_path_ = "gather"
            barrs = (jnp.asarray(verts), jnp.asarray(vmask), kcell)
        else:
            self.kernel_path_ = "dense"
            barrs = (lmops.vertex_membership_matrix(verts, vmask, n_static),)

        def landmark_fn(mobile, static, *barrs):
            if mxu_basis is not None:
                from sitator_tpu.ops.landmark_mxu import mxu_landmark_blocks
                uidx, Am, kill, ref_u, anchors, inv_order, kcell_a = barrs
                return mxu_landmark_blocks(
                    mobile, static,
                    dict(uidx=uidx, A=Am, kill=kill, ref_u=ref_u,
                         anchors=anchors, inv_order=inv_order,
                         cost_ratio=0.0, site_order=None, **bstat),
                    kcell_a,
                    midpoint=self.cutoff_midpoint,
                    steepness=self.cutoff_steepness,
                    cutoff_shape=self.cutoff_shape,
                    interpret=self.interpret)
            if use_fused:
                from sitator_tpu.ops.landmark_gather import \
                    gather_landmark_vectors
                verts_a, vmask_a, kcell_a = barrs
                return gather_landmark_vectors(
                    mobile, static, verts_a, vmask_a, kcell_a,
                    midpoint=self.cutoff_midpoint,
                    steepness=self.cutoff_steepness,
                    cutoff_shape=self.cutoff_shape)
            return lmops.landmark_vectors(
                mobile, static, barrs[0], cell_j, cell_inv_j,
                self.cutoff_midpoint, self.cutoff_steepness,
                cutoff_shape=self.cutoff_shape)

        @jax.jit
        def block_fn(mobile, static, *barrs):
            if mxu_basis is not None and self.mesh is not None:
                # a Pallas call cannot be GSPMD-auto-partitioned: run the
                # tiled stage per frame shard
                from sitator_tpu.parallel.mesh import shard_map_frames
                lv, = shard_map_frames(
                    lambda m, s, *b: (landmark_fn(m, s, *b),), self.mesh, 2,
                    mobile, static, *barrs, n_outputs=1)
            else:
                lv = landmark_fn(mobile, static, *barrs)
            lv = lmops.peak_even(lv, mode)
            lv_n, norms = lmops.normalize_landmark_vectors(lv)
            drift = lmops.static_drift_per_frame(static, static_ref, cell_j,
                                                 cell_inv_j)
            return lv_n, norms, drift

        # -- blockwise landmark computation (fixed shapes; pad last block) --
        B = min(self.batch_frames, n_frames)
        sharding = None
        if self.mesh is not None:
            from sitator_tpu.parallel.mesh import frame_sharding
            n_dev = self.mesh.devices.size
            B = max(B // n_dev, 1) * n_dev  # blocks divide the mesh
            sharding = frame_sharding(self.mesh)
        lv_bytes = 4 * n_frames * n_mobile * n_landmarks
        if lv_bytes > 4 << 30:
            # reference parity requires exposing .landmark_vectors, which
            # means a host-resident (F·M, S) matrix; beyond a few GB the
            # streaming engine is the right tool
            logger.warning(
                "landmark-vector matrix is %.1f GiB of host RAM; for long "
                "trajectories use StreamingLandmarkAnalysis (two-pass, "
                "O(block) memory)", lv_bytes / 2**30)
        lv_all = np.empty((n_frames, n_mobile, n_landmarks), dtype=np.float32)
        n_zero = 0
        first_zero = None
        max_drift = 0.0
        thr = self.static_movement_threshold
        perm = np.arange(n_static)  # slot → atom (identity until exchanges)
        n_remaps = 0
        static_ref_np = np.asarray(sn.structure.positions[static_idx],
                                   np.float64)
        from sitator_tpu.util.progress import get_progress_bar
        pbar = get_progress_bar(total=n_frames, enabled=self.verbose,
                                desc="landmark vectors", unit="frame")
        pos = 0
        last_remap = (-1, 0)
        while pos < n_frames:
            hi = min(pos + B, n_frames)
            blk = frames[pos:hi]
            if hi - pos < B:  # pad to the jitted block shape
                from sitator_tpu.parallel.mesh import pad_frames
                blk, _ = pad_frames(blk, B)
            static_np = blk[:, static_idx]
            if self.dynamic_lattice_mapping:
                static_np = static_np[:, perm]
            mobile = jnp.asarray(blk[:, mobile_idx], dtype=jnp.float32)
            static = jnp.asarray(static_np, dtype=jnp.float32)
            if sharding is not None:
                mobile = jax.device_put(mobile, sharding)
                static = jax.device_put(static, sharding)
            lv_n, norms, drift = block_fn(mobile, static, *barrs)
            drift_f = np.asarray(drift)[: hi - pos]
            n_ok = hi - pos
            if self.dynamic_lattice_mapping and (drift_f > thr).any():
                # accept frames before the exchange, rebuild the slot→atom
                # permutation at the first offending frame, reprocess from it
                f_rel = int(np.argmax(drift_f > thr))
                if pos + f_rel == last_remap[0]:
                    if last_remap[1] >= 3:
                        raise StaticLatticeError(
                            "lattice remapping did not converge at frame "
                            f"{pos + f_rel}", frame=pos + f_rel)
                    last_remap = (pos + f_rel, last_remap[1] + 1)
                else:
                    last_remap = (pos + f_rel, 1)
                n_ok = f_rel
            if n_ok:
                lv_all[pos:pos + n_ok] = np.asarray(lv_n)[:n_ok]
                # <= the normalize floor: below it the row could not be
                # normalized (stays sub-unit garbage), which is exactly
                # "saw no landmark" — an exact ==0 test lets ~1e-13 raw
                # norms through and they later poison cosine clustering
                zn = np.asarray(norms)[:n_ok] <= 1e-12
                if zn.any():
                    n_zero += int(zn.sum())
                    if first_zero is None:
                        f, m = np.argwhere(zn)[0]
                        first_zero = (int(pos + f), int(m))
                valid = drift_f[:n_ok]
                if len(valid):
                    max_drift = max(max_drift, float(valid.max()))
            if n_ok < hi - pos:
                new_perm = self._remap_lattice(
                    frames[pos + n_ok, static_idx], perm, static_ref_np,
                    sn.structure.cell, pos + n_ok)
                if np.array_equal(new_perm, perm):
                    # f32 device drift grazed the threshold but the f64
                    # matching finds no offenders: the frame is valid —
                    # accept it (prevents a no-progress remap loop)
                    f = n_ok
                    lv_all[pos + f] = np.asarray(lv_n)[f]
                    zrow = np.asarray(norms)[f] <= 1e-12
                    if zrow.any():
                        n_zero += int(zrow.sum())
                        if first_zero is None:
                            first_zero = (int(pos + f),
                                          int(np.argmax(zrow)))
                    n_ok += 1
                else:
                    perm = new_perm
                    n_remaps += 1
            pbar.update(n_ok)
            pos += n_ok
        pbar.close()

        if self.dynamic_lattice_mapping:
            if n_remaps and self.verbose:
                logger.info("dynamic lattice mapping: %d slot→atom remaps",
                            n_remaps)
            self.lattice_mapping_ = perm
        elif max_drift > thr:
            raise StaticLatticeError(
                f"a static-lattice atom drifted {max_drift:.3f} Å "
                f"(> threshold {thr} Å); the host lattice moved too much "
                "for landmark analysis (see dynamic_lattice_mapping for "
                "site-exchanging lattices)",
                max_drift=max_drift)
        if n_zero:
            msg = (f"{n_zero} (frame, ion) samples "
                   f"({100.0 * n_zero / (n_frames * n_mobile):.3f}%) saw no "
                   f"landmark (first at frame {first_zero[0]}, mobile ion "
                   f"{first_zero[1]}); widen cutoff_midpoint or check masks")
            if self.check_for_zero_landmarks:
                raise ZeroLandmarkError(msg, frame=first_zero[0],
                                        mobile_index=first_zero[1])
            logger.warning(msg)

        self._landmark_vectors = lv_all.reshape(n_frames * n_mobile,
                                                n_landmarks)

        # -- clustering ----------------------------------------------------
        backend = get_backend(self.clustering_algorithm)
        min_samples = max(1, int(np.ceil(
            self.minimum_site_occupancy * n_frames)))
        counts, labels, confs, centers_vec = backend.do_landmark_clustering(
            self._landmark_vectors, self.clustering_params, min_samples,
            verbose=self.verbose)
        n_sites = len(counts)
        if n_sites == 0:
            raise InsufficientSitesError(
                "clustering found no sites above minimum_site_occupancy "
                f"({self.minimum_site_occupancy}); lower it or adjust the "
                "cutoff/clustering thresholds")
        if self.verbose:
            logger.info("LandmarkAnalysis: %d sites from %d landmarks "
                        "(%.2f%% unassigned)", n_sites, n_landmarks,
                        100.0 * np.mean(labels < 0))

        # -- site centers: PBC-aware (weighted) mean of member positions ---
        calc = PBCCalculator(sn.structure.cell)
        flat_pos = frames[:, mobile_idx, :].reshape(-1, 3)
        w = confs if self.weighted_site_positions else None
        site_centers = np.empty((n_sites, 3))
        for k in range(n_sites):
            members = labels == k
            site_centers[k] = calc.average(
                flat_pos[members], None if w is None else w[members])

        # -- assemble the output network -----------------------------------
        out = SiteNetwork(sn.structure, sn.static_mask, sn.mobile_mask)
        out.centers = site_centers
        # landmark provenance: each site inherits the vertex polyhedron of
        # its dominant landmark (reference: vertices from landmark identity)
        dominant = np.argmax(centers_vec, axis=1)
        out.vertices = [sn.vertices[d] for d in dominant]
        out.add_site_attribute("dominant_landmark",
                               dominant.astype(np.int32))

        traj = labels.reshape(n_frames, n_mobile)
        confs2 = confs.reshape(n_frames, n_mobile)
        st = SiteTrajectory(out, traj, confs2)
        st.set_real_traj(frames)

        if self.max_mobile_per_site is not None:
            self._check_multiple_occupancy(traj, n_sites, n_frames)
        return st

    @staticmethod
    def _find_lattice_mapping(static_pos, perm, static_ref, cell, threshold):
        """Rebuild the slot→atom permutation at a site exchange.

        ``static_pos`` (N, 3): current static-atom positions (original atom
        order); ``perm`` (N,): current slot→atom map; ``static_ref`` (N, 3):
        reference slot positions.  Atoms that drifted beyond ``threshold``
        from their slot are re-matched to the displaced slots by min-image
        Hungarian assignment.  Returns (new_perm, matched_max_distance) or
        (None, best_distance) when no consistent mapping exists.
        """
        calc = PBCCalculator(cell)
        d = calc.paired_distances(static_pos[perm], static_ref)
        off = d > threshold
        if not off.any():
            return perm, float(d.max())
        off_slots = np.flatnonzero(off)
        atoms = perm[off_slots]
        D = calc.pairwise_distances(static_pos[atoms],
                                    static_ref[off_slots])
        from scipy.optimize import linear_sum_assignment
        r, c = linear_sum_assignment(D)
        worst = float(D[r, c].max())
        if worst > threshold:
            return None, worst
        new_perm = perm.copy()
        new_perm[off_slots[c]] = atoms[r]
        return new_perm, worst

    def _remap_lattice(self, static_pos, perm, static_ref, cell, frame):
        new_perm, worst = self._find_lattice_mapping(
            static_pos, perm, static_ref, cell,
            self.static_movement_threshold)
        if new_perm is None:
            raise StaticLatticeError(
                f"no consistent lattice mapping at frame {frame}: a "
                f"displaced static atom is {worst:.3f} Å from every "
                "vacated lattice site (> threshold "
                f"{self.static_movement_threshold} Å)", frame=frame,
                max_drift=worst)
        if self.verbose:
            n_moved = int((new_perm != perm).sum())
            logger.info("frame %d: lattice site exchange — remapped %d "
                        "slots (max residual %.3f Å)", frame, n_moved, worst)
        return new_perm

    def _check_multiple_occupancy(self, traj, n_sites, n_frames):
        if self.multiple_occupancy_action == "ignore":
            return
        ok = traj >= 0
        flat = traj.astype(np.int64) + n_sites * np.arange(n_frames)[:, None]
        counts = np.bincount(flat[ok].ravel(), minlength=n_sites * n_frames)
        n_viol = int(np.sum(counts > self.max_mobile_per_site))
        if not n_viol:
            return
        msg = (f"{n_viol} (frame, site) occupancies exceed "
               f"max_mobile_per_site={self.max_mobile_per_site} — sites may "
               "be under-resolved (consider lowering merge thresholds)")
        if self.multiple_occupancy_action == "raise":
            first = int(np.argmax(counts > self.max_mobile_per_site))
            from sitator_tpu.util.errors import MultipleOccupancyError
            raise MultipleOccupancyError(
                msg, frame=first // n_sites, site=first % n_sites,
                count=int(counts[first]))
        logger.warning(msg)
