"""Multi-device tests on the 8-virtual-CPU mesh (SURVEY.md §5 item 4):
parallel jump stats == sequential scan; sharded pipeline == single-chip."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sitator_tpu import SiteNetwork
from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis
from sitator_tpu.ops.cluster import dotprod_fit
from sitator_tpu.ops.jumps import jump_stats, jump_stats_parallel
from sitator_tpu.parallel import (
    SpmdLandmarkPipeline,
    frame_mesh,
    shard_frames,
)
from sitator_tpu.voronoi import VoronoiSiteGenerator

STAT_KEYS = ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts",
             "last_sites", "last_res")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parallel_jump_stats_exact(seed):
    rng = np.random.default_rng(seed)
    S = 6
    traj = rng.integers(-1, S, size=(97, 5)).astype(np.int32)
    a = jump_stats(jnp.asarray(traj), S)
    b = jump_stats_parallel(jnp.asarray(traj), S)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_parallel_jump_stats_all_unknown():
    traj = np.full((10, 3), -1, dtype=np.int32)
    b = jump_stats_parallel(jnp.asarray(traj), 4)
    assert np.asarray(b.n_ij).sum() == 0
    np.testing.assert_array_equal(np.asarray(b.last_sites), [-1, -1, -1])
    np.testing.assert_array_equal(np.asarray(b.last_res), [0, 0, 0])


def test_parallel_jump_stats_sharded_matches():
    """Same result when the frame axis is actually sharded over 8 devices."""
    rng = np.random.default_rng(7)
    S = 5
    traj = rng.integers(-1, S, size=(160, 4)).astype(np.int32)
    want = jump_stats(jnp.asarray(traj), S)
    mesh = frame_mesh()
    sharded = shard_frames(traj, mesh)
    got = jump_stats_parallel(sharded, S)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(np.asarray(want[k]), np.asarray(got[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def fitted_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=400,
                                 jump_rate=0.03, seed=3)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False)
    st = la.run(seeds, md.traj)
    # fit cluster centers from the analysis' landmark vectors
    res = dotprod_fit(jnp.asarray(la.landmark_vectors), k_max=128,
                      cluster_threshold=0.45, min_samples=4)
    return md, seeds, res


def test_sharded_pipeline_matches_single_device(fitted_system):
    """Frame-shard invariance: 8-device mesh == 1-device mesh, bit-exact."""
    md, seeds, res = fitted_system
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              assignment_threshold=0.35)
    pipe8 = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                 mesh=frame_mesh(), **kw)
    pipe1 = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                 mesh=frame_mesh(n_devices=1), **kw)
    lab8, conf8, stats8 = pipe8.run_block(md.traj)
    lab1, conf1, stats1 = pipe1.run_block(md.traj)
    np.testing.assert_array_equal(lab8, lab1)
    np.testing.assert_allclose(conf8, conf1, atol=1e-6)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(stats8[k], stats1[k], err_msg=k)


def test_pipeline_padding_correction(fitted_system):
    """A block whose length does not divide the mesh still gives exact
    occupancy/residence stats."""
    md, seeds, res = fitted_system
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              assignment_threshold=0.35)
    pipe8 = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                 mesh=frame_mesh(), **kw)
    pipe1 = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                 mesh=frame_mesh(n_devices=1), **kw)
    odd = md.traj[:395]  # 395 % 8 != 0
    lab8, _, stats8 = pipe8.run_block(odd)
    lab1, _, stats1 = pipe1.run_block(odd)
    assert lab8.shape[0] == 395
    np.testing.assert_array_equal(lab8, lab1)
    for k in STAT_KEYS:
        np.testing.assert_array_equal(stats8[k], stats1[k], err_msg=k)


def test_pipeline_matches_landmark_analysis(fitted_system):
    """The SPMD pipeline's assignments agree with the plain LandmarkAnalysis
    path when given the same centers (sanity of the fused step)."""
    md, seeds, res = fitted_system
    pipe = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                cutoff_midpoint=4.0, cutoff_steepness=3.0,
                                assignment_threshold=0.35)
    labels, confs, _ = pipe.run_block(md.traj[:64])
    # re-derive directly from landmark ops on one device
    from sitator_tpu.ops import landmark as lmops
    verts, vmask = seeds.padded_vertices()
    A = lmops.vertex_membership_matrix(verts, vmask, int(md.static_mask.sum()))
    cell = jnp.asarray(md.structure.cell, jnp.float32)
    cinv = jnp.asarray(np.linalg.inv(md.structure.cell), jnp.float32)
    mobile = jnp.asarray(md.traj[:64][:, md.mobile_mask], jnp.float32)
    static = jnp.asarray(md.traj[:64][:, md.static_mask], jnp.float32)
    lv = lmops.landmark_vectors(mobile, static, A, cell, cinv, 4.0, 3.0)
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    want_lab, want_conf = lmops.assign_to_centers(
        lvn, res["centers"], res["active"], 0.35)
    np.testing.assert_array_equal(labels, np.asarray(want_lab))


def test_fused_spmd_step_matches_xla(fitted_system):
    """The gather path under shard_map on the 8-device mesh equals the
    dense XLA analysis step."""
    import jax
    from sitator_tpu.parallel.pipeline import analysis_step, \
        fused_analysis_step
    from sitator_tpu.ops.landmark import vertex_membership_matrix

    md, seeds, res = fitted_system
    mesh = frame_mesh()
    F = 64
    frames = md.traj[:F]
    mobile = jnp.asarray(frames[:, md.mobile_mask], jnp.float32)
    static = jnp.asarray(frames[:, md.static_mask], jnp.float32)
    verts, vmask = seeds.padded_vertices()
    cell = jnp.asarray(md.structure.cell, jnp.float32)
    cell_inv = jnp.asarray(np.linalg.inv(md.structure.cell), jnp.float32)
    cell_diag = jnp.asarray(np.diag(md.structure.cell), jnp.float32)
    # the fused step takes only live center rows (no active mask)
    centers = jnp.asarray(np.asarray(res["centers"])[np.asarray(
        res["active"])])
    K = centers.shape[0]

    sh = shard_frames
    labels_f, confs_f, stats_f = fused_analysis_step(
        mesh, sh(np.asarray(mobile), mesh), sh(np.asarray(static), mesh),
        jnp.asarray(verts), jnp.asarray(vmask), cell_diag, centers,
        midpoint=4.0, steepness=3.0, threshold=0.35, mxu_bf16=False)

    A = vertex_membership_matrix(verts, vmask, int(md.static_mask.sum()))
    labels_x, confs_x, stats_x = analysis_step(
        mobile, static, A, cell, cell_inv, centers, jnp.ones(K, bool),
        4.0, 3.0, 0.35, n_sites=K)
    np.testing.assert_array_equal(np.asarray(labels_f), np.asarray(labels_x))
    np.testing.assert_array_equal(np.asarray(stats_f["n_ij"]),
                                  np.asarray(stats_x["n_ij"]))


def test_pipeline_fused_mode_matches_xla_mode(fitted_system):
    """SpmdLandmarkPipeline(use_fused=True, interpret) == XLA mode, with the
    caller's (non-compacted) cluster indexing preserved."""
    md, seeds, res = fitted_system
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              assignment_threshold=0.35, mesh=frame_mesh())
    pipe_x = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                  use_fused=False, **kw)
    pipe_f = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                  use_fused=True, interpret=True, **kw)
    block = md.traj[:64]
    lab_x, conf_x, stats_x = pipe_x.run_block(block)
    lab_f, conf_f, stats_f = pipe_f.run_block(block)
    np.testing.assert_array_equal(lab_x, lab_f)
    np.testing.assert_array_equal(stats_x["n_ij"], stats_f["n_ij"])


def test_run_block_carry_chains_across_blocks(fitted_system):
    """Passing carry=(last_sites, last_res) between consecutive run_block
    calls connects boundary jumps and residences exactly: per-block stats
    sum to the single-shot stats."""
    md, seeds, res = fitted_system
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              assignment_threshold=0.35)
    pipe = SpmdLandmarkPipeline(seeds, res["centers"], res["active"],
                                mesh=frame_mesh(), **kw)
    lab_all, _, s_all = pipe.run_block(md.traj)

    l1, _, s1 = pipe.run_block(md.traj[:179])   # odd split + padding
    l2, _, s2 = pipe.run_block(
        md.traj[179:], carry=(s1["last_sites"], s1["last_res"]))
    np.testing.assert_array_equal(np.concatenate([l1, l2]), lab_all)
    for k in ("n_ij", "lag_sum", "res_sum", "res_cnt", "occ_counts"):
        np.testing.assert_array_equal(s1[k] + s2[k], s_all[k], err_msg=k)
    np.testing.assert_array_equal(s2["last_sites"], s_all["last_sites"])
    np.testing.assert_array_equal(s2["last_res"], s_all["last_res"])

    # without the carry, a boundary jump is (correctly) uncounted
    _, _, s2n = pipe.run_block(md.traj[179:])
    assert (s1["n_ij"] + s2n["n_ij"]).sum() <= s_all["n_ij"].sum()


def test_shard_frames_local_matches_global():
    """shard_frames_local (the multi-process pod feeding form) equals
    shard_frames for a single process on the virtual mesh, including
    through a sharded computation."""
    import jax
    import jax.numpy as jnp
    from sitator_tpu.parallel.mesh import (frame_mesh, shard_frames,
                                           shard_frames_local)

    mesh = frame_mesh(n_devices=8)
    x = np.arange(8 * 4 * 3, dtype=np.float32).reshape(8, 4, 3)
    a = shard_frames(x, mesh)
    b = shard_frames_local(x, mesh)
    assert a.sharding.is_equivalent_to(b.sharding, a.ndim)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    f = jax.jit(lambda v: jnp.sum(v * v, axis=(1, 2)))
    np.testing.assert_array_equal(np.asarray(f(a)), np.asarray(f(b)))
