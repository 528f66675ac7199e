"""Streaming pipeline: block-chained results must equal the in-memory path."""
import numpy as np
import pytest

import jax.numpy as jnp

from sitator_tpu import SiteNetwork, SiteTrajectory
from sitator_tpu.dynamics import JumpAnalysis
from sitator_tpu.io import ArrayTrajectory, make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis, StreamingLandmarkAnalysis
from sitator_tpu.ops.pbc import PBCCalculator
from sitator_tpu.voronoi import VoronoiSiteGenerator


@pytest.fixture(scope="module")
def md_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=700,
                                 jump_rate=0.03, seed=9)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    return md, seeds


class Interrupt(Exception):
    pass


class FlakyReader(ArrayTrajectory):
    """Reader that raises Interrupt after serving ``die_after`` blocks —
    the shared interrupted-run fixture for checkpoint-resume tests."""

    def __init__(self, arr, die_after):
        super().__init__(arr)
        self.served = 0
        self.die_after = die_after

    def __getitem__(self, key):
        self.served += 1
        if self.die_after is not None and self.served > self.die_after:
            raise Interrupt()
        return super().__getitem__(key)



def test_streaming_matches_inmemory(md_system, tmp_path):
    md, seeds = md_system
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=128,
        fit_frames=700, store_labels=str(tmp_path / "labels.npy"),
        verbose=False)
    out = sla.run(seeds, md.traj)
    K = sla.n_sites_
    assert K > 0

    # in-memory comparison path with the SAME fitted centers: per-block
    # streaming must reproduce whole-trajectory statistics exactly
    labels = np.load(tmp_path / "labels.npy")
    st = SiteTrajectory(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
        if False else out, labels)
    JumpAnalysis(verbose=False).run(st)
    # the streamed n_ij equals the jump analysis of the streamed labels
    # (carry chaining across 128-frame blocks is exact)
    np.testing.assert_array_equal(out.n_ij, st.site_network.n_ij)

    # occupancies consistent
    occ = np.bincount(labels[labels >= 0], minlength=K) / md.n_frames
    np.testing.assert_allclose(out.occupancies, occ, atol=1e-12)

    # centers from toroidal means sit on true sites
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(out.centers, md.true_sites)
    assert d.min(axis=1).max() < 0.8


def test_streaming_block_size_invariance(md_system):
    """Different block sizes (including non-dividing) give identical stats."""
    md, seeds = md_system
    sla1 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=701, verbose=False)
    centers = sla1.fit_centers(seeds, ArrayTrajectory(md.traj))
    out1 = sla1.run(seeds, md.traj, centers=centers)
    sla2 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=96, verbose=False)
    out2 = sla2.run(seeds, md.traj, centers=centers)
    np.testing.assert_array_equal(out1.n_ij, out2.n_ij)
    np.testing.assert_allclose(out1.occupancies, out2.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out1.residence_times, out2.residence_times,
                               equal_nan=True)
    d = np.linalg.norm(out1.centers - out2.centers, axis=1)
    assert d.max() < 1e-4


def test_streaming_jump_parity_vs_ground_truth(md_system):
    md, seeds = md_system
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100, verbose=False)
    out = sla.run(seeds, md.traj)
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(out.centers, md.true_sites)
    site_map = d.argmin(axis=1)
    got = np.zeros_like(md.true_n_ij)
    for a in range(out.n_sites):
        for b in range(out.n_sites):
            got[site_map[a], site_map[b]] += out.n_ij[a, b]
    n_true = md.true_n_ij.sum()
    # raw streaming (no merge/debounce) may double-count flickers slightly
    assert abs(int(got.sum()) - n_true) <= max(3, 0.15 * n_true)


def test_streaming_checkpoint_resume(md_system, tmp_path):
    """A run interrupted mid-stream resumes from its checkpoint and produces
    bit-identical statistics to an uninterrupted run."""
    md, seeds = md_system
    from sitator_tpu.io import ArrayTrajectory
    ref = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100, verbose=False)
    centers = ref.fit_centers(seeds, ArrayTrajectory(md.traj))
    out_ref = ref.run(seeds, md.traj, centers=centers)

    ckpt = str(tmp_path / "run.ckpt")

    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=100,
                                    checkpoint_path=ckpt, checkpoint_every=2,
                                    verbose=False)
    with pytest.raises(Interrupt):
        sla.run(seeds, FlakyReader(md.traj, die_after=4), centers=centers)
    import os
    assert os.path.exists(ckpt)

    out = sla.run(seeds, FlakyReader(md.traj, die_after=None),
                  centers=centers)
    np.testing.assert_array_equal(out.n_ij, out_ref.n_ij)
    np.testing.assert_allclose(out.occupancies, out_ref.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out.centers, out_ref.centers, atol=1e-5)
    assert not os.path.exists(ckpt)  # cleaned up after completion


def test_streaming_mesh_fused_matches_single_device(md_system):
    """The fused Pallas path under an 8-device mesh (shard_map inside
    _stream_block) is bit-exact vs the same kernel on one device."""
    md, seeds = md_system
    from sitator_tpu.parallel.mesh import frame_mesh
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=64, use_fused=True,
                                     interpret=True, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    out1 = base.run(seeds, md.traj[:256], centers=centers)
    mesh = frame_mesh(n_devices=8)
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=64, mesh=mesh,
                                    use_fused=True, interpret=True,
                                    verbose=False)
    out8 = sla.run(seeds, md.traj[:256], centers=centers)
    np.testing.assert_array_equal(out1.n_ij, out8.n_ij)
    np.testing.assert_allclose(out1.occupancies, out8.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out1.centers, out8.centers, atol=1e-6)
    np.testing.assert_allclose(out1.residence_times, out8.residence_times,
                               equal_nan=True)


def test_streaming_spill_invariance(md_system):
    """Spilling device epochs to host int64/float64 every block changes
    nothing (the overflow-proofing is exact)."""
    md, seeds = md_system
    sla1 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = sla1.fit_centers(seeds, ArrayTrajectory(md.traj))
    out1 = sla1.run(seeds, md.traj, centers=centers)
    sla2 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    sla2.spill_every = 1
    out2 = sla2.run(seeds, md.traj, centers=centers)
    np.testing.assert_array_equal(out1.n_ij, out2.n_ij)
    np.testing.assert_allclose(out1.occupancies, out2.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out1.centers, out2.centers, atol=1e-6)


def test_streaming_multiple_occupancy_modes(md_system):
    """Two ions riding the same positions must trip the on-device
    multiple-occupancy counter: warn mode logs, raise mode raises."""
    md, seeds = md_system
    from sitator_tpu.util.errors import MultipleOccupancyError
    traj = md.traj[:200].copy()
    mob = np.flatnonzero(md.mobile_mask)
    traj[:, mob[1]] = traj[:, mob[0]]  # ion 1 shadows ion 0 exactly

    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=64,
                                    multiple_occupancy_action="raise",
                                    verbose=False)
    centers = sla.fit_centers(seeds, ArrayTrajectory(md.traj))
    with pytest.raises(MultipleOccupancyError):
        sla.run(seeds, traj, centers=centers)

    sla_warn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                         cutoff_steepness=3.0,
                                         block_frames=64,
                                         multiple_occupancy_action="warn",
                                         verbose=False)
    out = sla_warn.run(seeds, traj, centers=centers)  # completes
    assert out.n_sites > 0

    sla_off = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                        cutoff_steepness=3.0,
                                        block_frames=64,
                                        max_mobile_per_site=None,
                                        verbose=False)
    out2 = sla_off.run(seeds, traj, centers=centers)
    np.testing.assert_array_equal(out.n_ij, out2.n_ij)


def test_landmark_analysis_multiple_occupancy_raise(md_system):
    md, seeds = md_system
    from sitator_tpu.landmark import LandmarkAnalysis
    from sitator_tpu.util.errors import MultipleOccupancyError
    traj = md.traj[:120].copy()
    mob = np.flatnonzero(md.mobile_mask)
    traj[:, mob[1]] = traj[:, mob[0]]
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          multiple_occupancy_action="raise", verbose=False)
    with pytest.raises(MultipleOccupancyError) as ei:
        la.run(seeds, traj)
    assert ei.value.count is not None and ei.value.count > 1


def test_streaming_static_drift_raises(md_system):
    """Streaming now monitors static-lattice drift per frame on device."""
    md, seeds = md_system
    from sitator_tpu.util.errors import StaticLatticeError
    bad = md.traj[:200].copy()
    sa = np.flatnonzero(md.static_mask)
    bad[120:, sa[0]] += 3.0
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=64, verbose=False)
    centers = sla.fit_centers(seeds, ArrayTrajectory(md.traj))
    with pytest.raises(StaticLatticeError):
        sla.run(seeds, bad, centers=centers)
    # disabling the guard lets the (invalid) run complete
    sla_off = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                        cutoff_steepness=3.0,
                                        block_frames=64,
                                        static_movement_threshold=None,
                                        verbose=False)
    out = sla_off.run(seeds, bad, centers=centers)
    assert out.n_sites > 0


def test_streaming_dynamic_lattice_mapping(md_system):
    """Two static atoms exchanging sites mid-stream: with
    dynamic_lattice_mapping the streamed statistics equal the unswapped
    run exactly; without it, StaticLatticeError."""
    md, seeds = md_system
    from sitator_tpu.util.errors import StaticLatticeError
    T = 233  # inside a block (block_frames=100)
    swapped = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[2], sa[17]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:500, j].copy(),
                                      md.traj[T:500, i].copy())

    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    out_ref = base.run(seeds, md.traj[:500], centers=centers)

    with pytest.raises(StaticLatticeError):
        StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            verbose=False).run(seeds, swapped, centers=centers)

    dyn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100,
                                    dynamic_lattice_mapping=True,
                                    verbose=False)
    out = dyn.run(seeds, swapped, centers=centers)
    sidx = np.flatnonzero(seeds.static_mask)
    si = np.flatnonzero(sidx == i)[0]
    sj = np.flatnonzero(sidx == j)[0]
    assert dyn.lattice_mapping_[si] == sj
    assert dyn.lattice_mapping_[sj] == si
    np.testing.assert_array_equal(out.n_ij, out_ref.n_ij)
    np.testing.assert_allclose(out.occupancies, out_ref.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out.centers, out_ref.centers, atol=1e-5)


def test_streaming_dynamic_mapping_no_consistent_perm(md_system):
    """A static atom that drifts off WITHOUT a vacated slot to claim has
    no consistent lattice mapping: even with dynamic_lattice_mapping the
    streaming engine must raise (classic-engine parity,
    test_landmark.py 'stranded atom' case) — and the error carries the
    offending frame and residual."""
    md, seeds = md_system
    from sitator_tpu.util.errors import StaticLatticeError
    T = 233
    broken = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    broken[T:, sa[2]] += 2.0  # drifts off; every other slot stays filled

    dyn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100,
                                    dynamic_lattice_mapping=True,
                                    verbose=False)
    centers = dyn.fit_centers(seeds, ArrayTrajectory(md.traj))
    with pytest.raises(StaticLatticeError,
                       match="no consistent lattice mapping") as ei:
        dyn.run(seeds, broken, centers=centers)
    assert ei.value.frame == T
    assert ei.value.max_drift is not None and ei.value.max_drift > 1.0


def test_streaming_dynamic_mapping_under_mesh(md_system):
    """Lattice remapping composes with the 8-device mesh: permutation is
    applied host-side before upload, shard_map sees ordinary blocks."""
    md, seeds = md_system
    from sitator_tpu.parallel.mesh import frame_mesh
    T = 210
    swapped = md.traj[:400].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[3], sa[9]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:400, j].copy(),
                                      md.traj[T:400, i].copy())
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=80, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    out_ref = base.run(seeds, md.traj[:400], centers=centers)
    mesh = frame_mesh(n_devices=8)
    dyn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=80, mesh=mesh,
                                    use_fused=True, interpret=True,
                                    dynamic_lattice_mapping=True,
                                    verbose=False)
    out = dyn.run(seeds, swapped, centers=centers)
    np.testing.assert_array_equal(out.n_ij, out_ref.n_ij)
    np.testing.assert_allclose(out.occupancies, out_ref.occupancies,
                               atol=1e-12)


def test_streaming_dynamic_mapping_fit_pass(md_system):
    """The fit pass (pass 1) must follow lattice-site exchanges too: a run
    WITHOUT precomputed centers on a swapped trajectory reproduces the
    unswapped run bit-exactly (the permutation restores the exact bits)."""
    md, seeds = md_system
    T = 310
    swapped = md.traj.copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[4], sa[11]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:, j].copy(),
                                      md.traj[T:, i].copy())
    ref = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100,
                                    verbose=False).run(seeds, md.traj)
    dyn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100,
                                    dynamic_lattice_mapping=True,
                                    verbose=False)
    out = dyn.run(seeds, swapped)  # fit + stream, no precomputed centers
    assert out.n_sites == ref.n_sites
    np.testing.assert_array_equal(out.n_ij, ref.n_ij)
    np.testing.assert_allclose(out.occupancies, ref.occupancies,
                               atol=1e-12)


def test_streaming_checkpoint_resume_across_lattice_swap(md_system,
                                                         tmp_path):
    """A run interrupted AFTER a lattice-site exchange must resume with the
    checkpointed slot->atom permutation and still match the uninterrupted
    swapped run exactly."""
    md, seeds = md_system
    T = 150  # swap in block 2 (block_frames=100); interrupt after block 3
    swapped = md.traj[:600].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[6], sa[20]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:600, j].copy(),
                                      md.traj[T:600, i].copy())
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100,
                                     dynamic_lattice_mapping=True,
                                     verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    out_ref = base.run(seeds, swapped, centers=centers)

    ckpt = str(tmp_path / "swap.ckpt")
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=100,
                                    dynamic_lattice_mapping=True,
                                    checkpoint_path=ckpt,
                                    checkpoint_every=1, verbose=False)
    with pytest.raises(Interrupt):
        sla.run(seeds, FlakyReader(swapped, die_after=3), centers=centers)
    import os
    assert os.path.exists(ckpt)
    with np.load(ckpt) as d:  # the permutation rode the checkpoint
        assert "perm" in d.files
        assert (d["perm"] != np.arange(len(d["perm"]))).sum() == 2
    out = sla.run(seeds, FlakyReader(swapped, die_after=None),
                  centers=centers)
    np.testing.assert_array_equal(out.n_ij, out_ref.n_ij)
    np.testing.assert_allclose(out.occupancies, out_ref.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out.centers, out_ref.centers, atol=1e-5)


def test_streaming_agrees_with_spmd_pipeline(md_system, tmp_path):
    """Cross-engine consistency: with the same fitted centers, the
    streaming engine's spilled labels equal SpmdLandmarkPipeline's labels
    (both through their respective XLA paths on CPU)."""
    md, seeds = md_system
    from sitator_tpu.parallel.pipeline import SpmdLandmarkPipeline
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100,
                                     store_labels=str(tmp_path / "l.npy"),
                                     verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    base.run(seeds, md.traj[:300], centers=centers)
    lab_stream = np.load(tmp_path / "l.npy")[:300]

    pipe = SpmdLandmarkPipeline(
        seeds, centers, np.ones(len(centers), bool),
        cutoff_midpoint=4.0, cutoff_steepness=3.0, use_fused=False)
    lab_pipe, _, _ = pipe.run_block(md.traj[:300])
    np.testing.assert_array_equal(lab_stream, lab_pipe)


def test_streaming_merge_network(md_system):
    """Stats-level post-merge collapses split sites; inter-group hop counts
    approach ground truth."""
    md, seeds = md_system
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=128, verbose=False)
    out = sla.run(seeds, md.traj)
    merged, remap = StreamingLandmarkAnalysis.merge_network(
        out, distance_threshold=2.0, verbose=False)
    assert merged.n_sites <= out.n_sites
    assert remap.shape == (out.n_sites,)
    # total occupancy conserved
    np.testing.assert_allclose(merged.occupancies.sum(),
                               out.occupancies.sum(), atol=1e-9)
    # merged hop counts closer to ground truth than raw
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(merged.centers, md.true_sites)
    site_map = d.argmin(axis=1)
    assert len(np.unique(site_map)) == merged.n_sites
    n_true = md.true_n_ij.sum()
    raw_err = abs(int(out.n_ij.sum()) - n_true)
    merged_err = abs(int(merged.n_ij.sum()) - n_true)
    assert merged_err <= raw_err
    assert merged_err <= max(5, 0.15 * n_true)


def test_streaming_fit_fused_matches_dense(md_system):
    """The fit pass through the lv-emitting tiled path reproduces the
    dense XLA fit (same clusters, centers to fp tolerance)."""
    md, seeds = md_system

    def fit(use_fused):
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0,
            use_fused=use_fused, interpret=True, verbose=False)
        return sla.fit_centers(seeds, ArrayTrajectory(md.traj))

    c_dense = fit(False)
    c_fused = fit(True)
    assert c_dense.shape == c_fused.shape
    np.testing.assert_allclose(c_dense, c_fused, atol=2e-5)


def test_streaming_wrap_hazard_self_heals(md_system, tmp_path):
    """Carried residences beyond int32 range (injected via a resume
    checkpoint) are routed through the exact host int64 jump scan with NO
    user action (VERDICT r3 weak #1): totals match the int64 oracle even
    where a lag tally exceeds int32 range, and the engine returns to the
    fast on-device scan once the bound clears."""
    md, seeds = md_system
    F = 400
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    K = len(centers)
    n_mobile = int(md.mobile_mask.sum())

    # forge a resume checkpoint whose carried residences are hazardous:
    # ion 0's open residence alone cannot even be HELD in int32
    ckpt = tmp_path / "hazard.ckpt"
    init_last = np.zeros(n_mobile, np.int64)
    init_res = np.zeros(n_mobile, np.int64)
    init_res[0] = 2**31 + 12345
    init_res[1 % n_mobile] = 2**30 + 777
    with open(ckpt, "wb") as f:  # np.savez(path) would append ".npz"
        np.savez(f, n_frames=F, K=K, next_lo=0,
                 carry_last=init_last, carry_res=init_res)

    lbl_path = tmp_path / "hazard_labels.npy"
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=100,
                                    checkpoint_path=str(ckpt),
                                    checkpoint_every=10**9,
                                    store_labels=str(lbl_path),
                                    verbose=False)
    sla.spill_every = 1  # re-evaluate the bound at every block
    out = sla.run(seeds, md.traj[:F], centers=centers)
    assert sla.exact_jump_epochs_ >= 1          # the self-heal engaged...
    assert sla.exact_jump_epochs_ < F // 100    # ...and later cleared

    from sitator_tpu.ops.jumps import jump_stats_exact
    labels = np.load(lbl_path)
    oracle = jump_stats_exact(labels, K, init_last=init_last,
                              init_res=init_res)
    # at least one closing jump carried a residence beyond int32 range —
    # an int32 tally would have wrapped
    assert oracle["lag_sum"].max() > np.iinfo(np.int32).max
    np.testing.assert_array_equal(out.n_ij, oracle["n_ij"])
    lag = np.where(oracle["n_ij"] > 0,
                   oracle["lag_sum"] / np.maximum(oracle["n_ij"], 1),
                   np.nan)
    np.testing.assert_allclose(out.jump_lag, lag, equal_nan=True)
    res = np.where(oracle["res_cnt"] > 0,
                   oracle["res_sum"] / np.maximum(oracle["res_cnt"], 1),
                   np.nan)
    np.testing.assert_allclose(out.residence_times, res, equal_nan=True)


def test_streaming_exact_mode_noop_on_healthy_runs(md_system):
    """The wrap protection must never engage (or change results) on an
    ordinary run: per-block spilling with the mode machinery active equals
    the plain run bit-for-bit."""
    md, seeds = md_system
    sla1 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = sla1.fit_centers(seeds, ArrayTrajectory(md.traj))
    out1 = sla1.run(seeds, md.traj, centers=centers)
    assert sla1.exact_jump_epochs_ == 0
    sla2 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    sla2.spill_every = 1
    out2 = sla2.run(seeds, md.traj, centers=centers)
    assert sla2.exact_jump_epochs_ == 0
    np.testing.assert_array_equal(out1.n_ij, out2.n_ij)
    np.testing.assert_allclose(out1.residence_times, out2.residence_times,
                               equal_nan=True)


def test_streaming_pipeline_depth_invariance(md_system):
    """The optimistic run-ahead dispatcher (pipeline_depth) must be
    invisible in the results: depths 0 (fully synchronous), 1 and 6
    produce bit-identical statistics — including across a mid-stream
    lattice-site exchange, which forces the rollback + replay path."""
    md, seeds = md_system
    T = 233
    swapped = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[2], sa[17]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:500, j].copy(),
                                      md.traj[T:500, i].copy())

    def run(depth, traj):
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            dynamic_lattice_mapping=True, pipeline_depth=depth,
            verbose=False)
        centers = run.centers
        return sla.run(seeds, traj, centers=centers)

    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    run.centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))

    for traj in (md.traj[:500], swapped):
        out0 = run(0, traj)
        for depth in (1, 6):
            outd = run(depth, traj)
            np.testing.assert_array_equal(out0.n_ij, outd.n_ij)
            np.testing.assert_allclose(out0.occupancies, outd.occupancies,
                                       atol=1e-12)
            np.testing.assert_allclose(out0.residence_times,
                                       outd.residence_times,
                                       equal_nan=True)
            np.testing.assert_allclose(out0.centers, outd.centers,
                                       atol=1e-6)


def test_streaming_pipeline_labels_identical(md_system, tmp_path):
    """Spilled label memmaps are identical across pipeline depths (the
    retire path writes them out of the in-flight window)."""
    md, seeds = md_system
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    labs = {}
    for depth in (0, 3):
        p = tmp_path / f"lab_{depth}.npy"
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            store_labels=str(p), pipeline_depth=depth, verbose=False)
        sla.run(seeds, md.traj, centers=centers)
        labs[depth] = np.load(p)
    np.testing.assert_array_equal(labs[0], labs[3])


def test_streaming_pipeline_with_checkpoint_resume(md_system, tmp_path):
    """Run-ahead composes with mid-run checkpointing: an interrupted
    pipelined run resumes bit-exactly (checkpoints drain the in-flight
    window, so no optimistic state is ever snapshotted)."""
    md, seeds = md_system
    ref = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100, verbose=False)
    centers = ref.fit_centers(seeds, ArrayTrajectory(md.traj))
    out_ref = ref.run(seeds, md.traj, centers=centers)

    ckpt = str(tmp_path / "pipe.ckpt")
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=100,
                                    checkpoint_path=ckpt,
                                    checkpoint_every=2, pipeline_depth=3,
                                    verbose=False)
    with pytest.raises(Interrupt):
        sla.run(seeds, FlakyReader(md.traj, die_after=4), centers=centers)
    import os
    assert os.path.exists(ckpt)
    out = sla.run(seeds, FlakyReader(md.traj, die_after=None),
                  centers=centers)
    np.testing.assert_array_equal(out.n_ij, out_ref.n_ij)
    np.testing.assert_allclose(out.occupancies, out_ref.occupancies,
                               atol=1e-12)


def test_streaming_pipeline_with_wrap_hazard(md_system, tmp_path):
    """Run-ahead composes with the self-healing wrap protection: in the
    exact-residence regime the engine falls back to the synchronous path
    per block, and totals still match the int64 oracle."""
    md, seeds = md_system
    F = 300
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    K = len(centers)
    n_mobile = int(md.mobile_mask.sum())
    ckpt = tmp_path / "pipe_hazard.ckpt"
    init_last = np.zeros(n_mobile, np.int64)
    init_res = np.zeros(n_mobile, np.int64)
    init_res[0] = 2**31 + 777
    with open(ckpt, "wb") as f:
        np.savez(f, n_frames=F, K=K, next_lo=0,
                 carry_last=init_last, carry_res=init_res)
    lbl = tmp_path / "pipe_hazard_labels.npy"
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=100,
                                    checkpoint_path=str(ckpt),
                                    checkpoint_every=10**9,
                                    store_labels=str(lbl),
                                    pipeline_depth=3, verbose=False)
    sla.spill_every = 1
    out = sla.run(seeds, md.traj[:F], centers=centers)
    assert sla.exact_jump_epochs_ >= 1
    from sitator_tpu.ops.jumps import jump_stats_exact
    labels = np.load(lbl)
    oracle = jump_stats_exact(labels, K, init_last=init_last,
                              init_res=init_res)
    np.testing.assert_array_equal(out.n_ij, oracle["n_ij"])
    lag = np.where(oracle["n_ij"] > 0,
                   oracle["lag_sum"] / np.maximum(oracle["n_ij"], 1),
                   np.nan)
    np.testing.assert_allclose(out.jump_lag, lag, equal_nan=True)


def test_streaming_packed_drift_with_rollback_and_labels(md_system,
                                                         tmp_path):
    """With store_labels + drift guard + run-ahead, the per-frame drift
    rides inside the label egress fetch (one retirement fetch per
    block); a mid-stream lattice swap forces the rollback path through
    that packed route and the results still equal the synchronous run
    bit-for-bit, labels included."""
    md, seeds = md_system
    T = 233
    swapped = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[2], sa[17]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:500, j].copy(),
                                      md.traj[T:500, i].copy())
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))

    outs, labs = {}, {}
    for depth in (0, 3):
        p = tmp_path / f"pk_{depth}.npy"
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            dynamic_lattice_mapping=True, store_labels=str(p),
            pipeline_depth=depth, verbose=False)
        sla.packed_retire = True  # the packed route under test
        outs[depth] = sla.run(seeds, swapped, centers=centers)
        labs[depth] = np.load(p)
    np.testing.assert_array_equal(labs[0], labs[3])
    np.testing.assert_array_equal(outs[0].n_ij, outs[3].n_ij)
    np.testing.assert_allclose(outs[0].occupancies, outs[3].occupancies,
                               atol=1e-12)


def test_spilled_labels_feed_postprocessing_engines(md_system, tmp_path):
    """Composability: the spilled label memmap reconstructs a
    SiteTrajectory whose JumpAnalysis statistics equal the streaming
    engine's on-device accumulators, and the label-based diagnostics
    (ResidenceTimeAnalysis) run on it directly."""
    md, seeds = md_system
    from sitator_tpu.core.sitetraj import SiteTrajectory
    from sitator_tpu.dynamics import JumpAnalysis, ResidenceTimeAnalysis

    eng = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=128,
                                    store_labels=str(tmp_path / "l.npy"),
                                    verbose=False)
    sn2 = eng.run(seeds, ArrayTrajectory(md.traj))
    labels = np.load(tmp_path / "l.npy", mmap_mode="r")
    assert labels.shape == (md.traj.shape[0], int(md.mobile_mask.sum()))

    st = SiteTrajectory(sn2, np.asarray(labels))
    ja = JumpAnalysis(verbose=False)
    # re-deriving on the host from the spilled labels must reproduce the
    # device accumulators exactly
    n_dev = np.asarray(sn2.n_ij).copy()
    ja.run(st)
    np.testing.assert_array_equal(np.asarray(st.site_network.n_ij),
                                  n_dev)
    ra = ResidenceTimeAnalysis(min_samples=5, verbose=False).run(st)
    assert np.isfinite(ra.p_value_).sum() >= 1


def test_phase_times_populated(md_system, tmp_path):
    """The per-phase host-dwell table (phase_times_) must cover the core
    pass-2 phases, be positive, and sum to no more than the run's wall
    (phases are disjoint on the fast path)."""
    import time

    md, seeds = md_system
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=128,
        fit_frames=700, store_labels=str(tmp_path / "labels_pt.npy"),
        verbose=False)
    t0 = time.perf_counter()
    sla.run(seeds, md.traj)
    wall = time.perf_counter() - t0
    pt = sla.phase_times_
    for name in ("feeder", "upload", "dispatch_assign", "dispatch_fold",
                 "drift_fetch", "labels_fetch", "labels_memmap_write",
                 "epoch_spill"):
        assert name in pt and pt[name] > 0.0, (name, pt)
    assert sum(pt.values()) <= wall * 1.001


def test_streaming_retire_group_invariance(md_system, tmp_path):
    """Group retirement (retire_group > 1: batched device->host fetches
    at retirement) must be invisible in the results — bit-identical
    statistics AND label memmaps vs per-block retirement, including
    across a mid-stream lattice swap (a drift offender mid-group forces
    the rollback-to-own-snapshot path) and on the packed
    (drift-rides-egress) route."""
    md, seeds = md_system
    T = 233
    swapped = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[2], sa[17]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:500, j].copy(),
                                      md.traj[T:500, i].copy())
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))

    ref = None
    for group, packed in ((1, False), (3, False), (5, False), (3, True)):
        p = tmp_path / f"rg_{group}_{int(packed)}.npy"
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            dynamic_lattice_mapping=True, store_labels=str(p),
            pipeline_depth=2, retire_group=group, verbose=False)
        sla.packed_retire = packed
        out = sla.run(seeds, swapped, centers=centers)
        lab = np.load(p)
        if ref is None:
            ref = (out, lab)
        else:
            np.testing.assert_array_equal(ref[1], lab)
            np.testing.assert_array_equal(ref[0].n_ij, out.n_ij)
            np.testing.assert_allclose(ref[0].occupancies,
                                       out.occupancies, atol=1e-12)
            np.testing.assert_allclose(ref[0].residence_times,
                                       out.residence_times,
                                       equal_nan=True)


def test_streaming_retire_group_guard_raises(md_system):
    """Without dynamic mapping, a drift offender retired mid-group must
    still raise StaticLatticeError at the SAME frame as the synchronous
    engine (the batched fetch changes when the guard looks, never what
    it sees); label spilling off exercises the drift-only batch."""
    md, seeds = md_system
    from sitator_tpu.util.errors import StaticLatticeError
    bad = md.traj[:300].copy()
    sa = np.flatnonzero(md.static_mask)
    bad[157:, sa[0]] += 3.0
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=64, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    frames = []
    for depth, group in ((0, 1), (2, 4)):
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=64,
            pipeline_depth=depth, retire_group=group, verbose=False)
        with pytest.raises(StaticLatticeError) as ei:
            sla.run(seeds, bad, centers=centers)
        frames.append(ei.value.frame)
    assert frames[0] == frames[1] == 157

def test_pack12_roundtrip():
    """The 12-bit egress pack is lossless over its full domain: labels
    in [-1, 4094] (unknown included), any column count (the pack pads
    to a multiple of 4), round-trip device-pack -> host-unpack."""
    from sitator_tpu.landmark.streaming import (_pack12, _unpack12,
                                                pack12_width)
    rng = np.random.default_rng(7)
    for n in (1, 3, 4, 7, 739, 128):
        lab = rng.integers(-1, 4095, size=(5, n)).astype(np.int32)
        # force the boundary values into the sample
        lab.flat[0] = -1
        lab.flat[-1] = 4094
        packed = np.asarray(_pack12(jnp.asarray(lab)))
        assert packed.dtype == np.int16
        assert packed.shape == (5, pack12_width(n))
        out = _unpack12(packed, n)
        np.testing.assert_array_equal(out, lab.astype(np.int16))


def test_streaming_egress_pack12_invariance(md_system, tmp_path):
    """The packed egress must be invisible in the results: bit-identical
    statistics AND label memmaps vs the plain int16 egress, including
    across a mid-stream lattice swap (rollback replays through the
    decode path) and combined with packed_retire / group retirement."""
    md, seeds = md_system
    T = 233
    swapped = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[2], sa[17]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:500, j].copy(),
                                      md.traj[T:500, i].copy())
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))

    ref = None
    for pack12, packed_retire, group in ((False, False, 1),
                                         (True, False, 1),
                                         (True, True, 1),
                                         (True, False, 3)):
        p = tmp_path / f"p12_{int(pack12)}_{int(packed_retire)}_{group}.npy"
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            dynamic_lattice_mapping=True, store_labels=str(p),
            pipeline_depth=2, retire_group=group,
            egress_pack12=pack12, verbose=False)
        sla.packed_retire = packed_retire
        out = sla.run(seeds, swapped, centers=centers)
        lab = np.load(p)
        if ref is None:
            ref = (out, lab)
        else:
            np.testing.assert_array_equal(ref[1], lab)
            np.testing.assert_array_equal(ref[0].n_ij, out.n_ij)
            np.testing.assert_allclose(ref[0].occupancies,
                                       out.occupancies, atol=1e-12)
            np.testing.assert_allclose(ref[0].residence_times,
                                       out.residence_times,
                                       equal_nan=True)


def test_streaming_egress_pack12_exact_mode(md_system, tmp_path):
    """pack12 composes with the exact int64 jump scan: the host scan
    consumes DECODED labels, so a wrap-hazard run with the pack on
    matches the run with it off."""
    md, seeds = md_system
    F = 300
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    K = len(centers)
    n_mobile = int(md.mobile_mask.sum())
    outs = []
    for pack12 in (False, True):
        ckpt = tmp_path / f"p12x_{int(pack12)}.ckpt"
        init_last = np.zeros(n_mobile, np.int64)
        init_res = np.zeros(n_mobile, np.int64)
        init_res[0] = 2**31 + 777   # forces the exact-residence regime
        with open(ckpt, "wb") as f:
            np.savez(f, n_frames=F, K=K, next_lo=0,
                     carry_last=init_last, carry_res=init_res)
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=100,
            checkpoint_path=str(ckpt), checkpoint_every=10**9,
            pipeline_depth=3, egress_pack12=pack12, verbose=False)
        sla.spill_every = 1
        outs.append(sla.run(seeds, md.traj[:F], centers=centers))
        assert sla.exact_jump_epochs_ >= 1
    np.testing.assert_array_equal(outs[0].n_ij, outs[1].n_ij)
    np.testing.assert_allclose(outs[0].residence_times,
                               outs[1].residence_times, equal_nan=True)


def test_streaming_egress_pack12_inactive_without_int16(md_system):
    """The pack needs the int16 regime: with egress_int16 forced off the
    engine must silently run unpacked (and still be correct)."""
    md, seeds = md_system
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    ref = base.run(seeds, md.traj[:300], centers=centers)
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=100,
                                    egress_pack12=True, verbose=False)
    sla.egress_int16 = False
    out = sla.run(seeds, md.traj[:300], centers=centers)
    np.testing.assert_array_equal(ref.n_ij, out.n_ij)

@pytest.mark.parametrize("seed", range(8))
def test_streaming_knob_lattice_fuzz(md_system, tmp_path, seed):
    """Randomized combinations across the WHOLE throughput-knob lattice
    (pipeline depth, retire group, egress int16/pack12, packed drift,
    block size, dynamic mapping) must be bit-identical to the
    synchronous baseline — knob interactions, not just the per-knob
    invariance the dedicated tests cover."""
    md, seeds = md_system
    rng = np.random.default_rng(300 + seed)
    T = 233
    traj = md.traj[:400].copy()
    if rng.integers(0, 2):   # half the runs cross a lattice swap
        sa = np.flatnonzero(md.static_mask)
        i, j = sa[2], sa[17]
        traj[T:, i], traj[T:, j] = (md.traj[T:400, j].copy(),
                                    md.traj[T:400, i].copy())
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))

    def run(tag, **kw):
        p = tmp_path / f"knob_{seed}_{tag}.npy"
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0,
            dynamic_lattice_mapping=True, store_labels=str(p),
            verbose=False, **kw)
        out = sla.run(seeds, traj, centers=centers)
        return out, np.load(p)

    ref_out, ref_lab = run("ref", block_frames=100, pipeline_depth=0,
                           egress_pack12=False)
    kw = dict(
        block_frames=int(rng.choice([64, 100, 128])),
        pipeline_depth=int(rng.integers(0, 4)),
        retire_group=int(rng.integers(1, 4)),
        egress_pack12=bool(rng.integers(0, 2)),
    )
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0,
        dynamic_lattice_mapping=True,
        store_labels=str(tmp_path / f"knob_{seed}_v.npy"),
        verbose=False, **kw)
    # independent draws: the engine itself gates illegal combinations
    # (packed drift needs the int16 regime, pack12 needs int16 + K<4096)
    sla.packed_retire = bool(rng.integers(0, 2))
    if not rng.integers(0, 2):
        sla.egress_int16 = False   # int32 egress leg of the lattice
    kw["packed_retire"] = sla.packed_retire
    kw["egress_int16"] = sla.egress_int16
    out = sla.run(seeds, traj, centers=centers)
    lab = np.load(tmp_path / f"knob_{seed}_v.npy")
    np.testing.assert_array_equal(ref_lab, lab, err_msg=str(kw))
    np.testing.assert_array_equal(ref_out.n_ij, out.n_ij,
                                  err_msg=str(kw))
    np.testing.assert_allclose(ref_out.occupancies, out.occupancies,
                               atol=1e-12, err_msg=str(kw))
    np.testing.assert_allclose(ref_out.residence_times,
                               out.residence_times, equal_nan=True,
                               err_msg=str(kw))


def test_streaming_ctor_validation():
    """Constructor rejections (coverage audit: untested raises)."""
    with pytest.raises(ValueError, match="multiple_occupancy_action"):
        StreamingLandmarkAnalysis(multiple_occupancy_action="explode")
    with pytest.raises(ValueError, match="static_movement_threshold"):
        StreamingLandmarkAnalysis(dynamic_lattice_mapping=True,
                                  static_movement_threshold=None)


def test_streaming_checkpoint_mismatch_raises(md_system, tmp_path):
    """A checkpoint written by a DIFFERENT run (frame count or K
    mismatch) must refuse to resume, not silently corrupt."""
    md, seeds = md_system
    ckpt = str(tmp_path / "stale.npz")   # savez appends .npz otherwise
    np.savez(ckpt, n_frames=12345, K=3, next_lo=64,
             carry_last=np.zeros(4, np.int64),
             carry_res=np.zeros(4, np.int64))
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0, block_frames=64,
                                    checkpoint_path=ckpt, verbose=False)
    centers = sla.fit_centers(seeds, ArrayTrajectory(md.traj[:128]))
    with pytest.raises(ValueError, match="checkpoint does not match"):
        sla.run(seeds, md.traj[:128], centers=centers)


def test_streaming_mesh_gather_kernel_matches_single_device(md_system,
                                                            monkeypatch):
    """The per-vertex GATHER kernel under an 8-device mesh (the mxu
    basis builder declining forces the gather plan) is bit-exact vs the
    same kernel on one device — the mesh tests otherwise always take
    the tiled path on this fixture."""
    md, seeds = md_system
    import sitator_tpu.ops.landmark_mxu as lmxu
    from sitator_tpu.parallel.mesh import frame_mesh
    monkeypatch.setattr(lmxu, "prepare_engine_basis",
                        lambda *a, **k: None)
    base = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=64, use_fused=True,
                                     interpret=True, verbose=False)
    centers = base.fit_centers(seeds, ArrayTrajectory(md.traj))
    out1 = base.run(seeds, md.traj[:256], centers=centers)
    mesh = frame_mesh(n_devices=8)
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=64, mesh=mesh,
                                    use_fused=True, interpret=True,
                                    verbose=False)
    out8 = sla.run(seeds, md.traj[:256], centers=centers)
    np.testing.assert_array_equal(out1.n_ij, out8.n_ij)
    np.testing.assert_allclose(out1.occupancies, out8.occupancies,
                               atol=1e-12)


def test_streaming_async_label_copy_invariance(md_system, tmp_path):
    """Opt-in async_label_copy (early device->host label copy) changes
    nothing about results — labels on disk and statistics are identical
    to the sync default (coverage audit: branch untested)."""
    md, seeds = md_system
    outs = {}
    for mode in (False, True):
        p = tmp_path / f"labels_{mode}.npy"
        sla = StreamingLandmarkAnalysis(
            cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=128,
            store_labels=str(p), async_label_copy=mode, verbose=False)
        centers = outs.get("centers")
        if centers is None:
            centers = sla.fit_centers(seeds, ArrayTrajectory(md.traj))
            outs["centers"] = centers
        outs[mode] = (sla.run(seeds, md.traj[:256], centers=centers),
                      np.load(p))
    np.testing.assert_array_equal(outs[False][1], outs[True][1])
    np.testing.assert_array_equal(outs[False][0].n_ij, outs[True][0].n_ij)
    np.testing.assert_allclose(outs[False][0].occupancies,
                               outs[True][0].occupancies, atol=1e-12)

def test_streaming_verbose_and_mesh_validation(md_system, tmp_path, caplog):
    """The verbose observability lines actually fire (fit summary,
    resume notice, remap count, final summary, per-frame exchange), and
    a mesh whose size does not divide block_frames is rejected."""
    import logging
    md, seeds = md_system
    T = 233
    swapped = md.traj[:500].copy()
    sa = np.flatnonzero(md.static_mask)
    i, j = sa[2], sa[17]
    swapped[T:, i], swapped[T:, j] = (md.traj[T:500, j].copy(),
                                      md.traj[T:500, i].copy())
    ckpt = str(tmp_path / "v.ckpt")
    dyn = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100,
                                    dynamic_lattice_mapping=True,
                                    checkpoint_path=ckpt,
                                    checkpoint_every=1, verbose=True)
    full = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=100,
                                     dynamic_lattice_mapping=True,
                                     verbose=True)
    with caplog.at_level(logging.INFO,
                         logger="sitator_tpu.landmark.streaming"):
        centers = dyn.fit_centers(seeds, ArrayTrajectory(md.traj))
        # complete run: the remap-count summary only prints at the end
        full.run(seeds, swapped, centers=centers)
        with pytest.raises(Interrupt):
            dyn.run(seeds, FlakyReader(swapped, die_after=3),
                    centers=centers)
        out = dyn.run(seeds, FlakyReader(swapped, die_after=None),
                      centers=centers)
    assert out.n_sites > 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any("streaming fit:" in m for m in msgs)
    assert any("resuming streaming run at frame" in m for m in msgs)
    assert any("lattice site exchange" in m for m in msgs)
    assert any("slot→atom remaps" in m for m in msgs)
    assert any(m.startswith("streaming run:") for m in msgs)

    from sitator_tpu.parallel.mesh import frame_mesh
    bad = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=100, mesh=frame_mesh(8),
                                    verbose=False)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        bad.run(seeds, swapped, centers=centers)


def test_merge_network_singleton_and_distance_guard():
    """merge_network's distance guard: a flicker-coupled pair too far
    apart to be one physical site stays split, and an isolated site
    passes through as a singleton group."""
    from sitator_tpu.core.structure import Structure
    structure = Structure(np.zeros((2, 3)), [16, 3], np.eye(3) * 20.0)
    sn = SiteNetwork(structure, np.array([1, 0], bool),
                     np.array([0, 1], bool))
    sn.centers = np.array([[1.0, 1.0, 1.0], [9.0, 9.0, 9.0],
                           [15.0, 15.0, 15.0]])
    sn.add_site_attribute("occupancies", np.array([0.4, 0.4, 0.2]))
    n_ij = np.array([[0, 50, 0], [50, 0, 0], [0, 0, 5]], np.int64)
    sn.add_edge_attribute("n_ij", n_ij)
    merged, remap = StreamingLandmarkAnalysis.merge_network(
        sn, distance_threshold=2.0, verbose=True)
    assert merged.n_sites == 3           # the distance guard held
    assert sorted(remap.tolist()) == [0, 1, 2]
    np.testing.assert_allclose(merged.occupancies.sum(),
                               sn.occupancies.sum(), atol=1e-12)
