"""Property tests (SURVEY.md §5 item 2): permutation equivariance, rigid
translation invariance of the full analysis, and multi-device streaming."""
import numpy as np
import pytest

from sitator_tpu import SiteNetwork
from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis, StreamingLandmarkAnalysis
from sitator_tpu.ops.pbc import PBCCalculator
from sitator_tpu.parallel import frame_mesh
from sitator_tpu.voronoi import VoronoiSiteGenerator


@pytest.fixture(scope="module")
def base_system():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=300,
                                 jump_rate=0.03, seed=21)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False)
    st = la.run(seeds, md.traj)
    return md, seeds, st


def test_mobile_permutation_equivariance(base_system):
    """Permuting the mobile atoms permutes the assignment columns — site
    discovery itself is unchanged."""
    md, seeds, st = base_system
    n_host = int(md.static_mask.sum())
    perm = np.array([2, 0, 3, 1])
    atom_order = np.concatenate([np.arange(n_host), n_host + perm])
    traj_p = md.traj[:, atom_order]

    from sitator_tpu.core.structure import Structure
    s_p = Structure(md.structure.positions[atom_order],
                    md.structure.species[atom_order], md.structure.cell)
    sn_p = SiteNetwork(s_p, md.static_mask, md.mobile_mask)
    seeds_p = VoronoiSiteGenerator(merge_tol=0.05).run(sn_p)
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False)
    st_p = la.run(seeds_p, traj_p)

    assert st_p.site_network.n_sites == st.site_network.n_sites
    # site labels may be numbered differently; map via centers
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(st_p.site_network.centers,
                                st.site_network.centers)
    mapping = d.argmin(axis=1)
    assert d[np.arange(len(mapping)), mapping].max() < 1e-3
    mapped = np.where(st_p.traj >= 0, mapping[st_p.traj], -1)
    np.testing.assert_array_equal(mapped, st.traj[:, perm])


def test_rigid_translation_invariance(base_system):
    """Translating every position by a constant vector leaves assignments
    identical (sites translate accordingly)."""
    md, seeds, st = base_system
    t = np.array([1.7, -2.3, 0.9], dtype=md.traj.dtype)
    from sitator_tpu.core.structure import Structure
    s_t = Structure(md.structure.positions + t, md.structure.species,
                    md.structure.cell)
    sn_t = SiteNetwork(s_t, md.static_mask, md.mobile_mask)
    seeds_t = VoronoiSiteGenerator(merge_tol=0.05).run(sn_t)
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False)
    st_t = la.run(seeds_t, md.traj + t)
    assert st_t.site_network.n_sites == st.site_network.n_sites
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(st_t.site_network.centers - t,
                                st.site_network.centers)
    mapping = d.argmin(axis=1)
    assert d[np.arange(len(mapping)), mapping].max() < 1e-2
    mapped = np.where(st_t.traj >= 0, mapping[st_t.traj], -1)
    np.testing.assert_array_equal(mapped, st.traj)


def test_streaming_on_mesh_matches_single_device(base_system):
    """Streaming over an 8-device frame mesh == single device, exactly."""
    md, seeds, st = base_system
    sla = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                    cutoff_steepness=3.0,
                                    block_frames=64, verbose=False)
    from sitator_tpu.io import ArrayTrajectory
    centers = sla.fit_centers(seeds, ArrayTrajectory(md.traj))
    out1 = sla.run(seeds, md.traj, centers=centers)

    sla8 = StreamingLandmarkAnalysis(cutoff_midpoint=4.0,
                                     cutoff_steepness=3.0,
                                     block_frames=64, mesh=frame_mesh(),
                                     verbose=False)
    out8 = sla8.run(seeds, md.traj, centers=centers)
    np.testing.assert_array_equal(out1.n_ij, out8.n_ij)
    np.testing.assert_allclose(out1.occupancies, out8.occupancies,
                               atol=1e-12)
    np.testing.assert_allclose(out1.centers, out8.centers, atol=1e-4)


def test_landmark_analysis_on_mesh_matches_single(base_system):
    """LandmarkAnalysis(mesh=8 devices) == single-device result exactly."""
    md, seeds, st = base_system
    la8 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                           mesh=frame_mesh(), verbose=False)
    st8 = la8.run(seeds, md.traj)
    np.testing.assert_array_equal(st8.traj, st.traj)
    np.testing.assert_allclose(st8.site_network.centers,
                               st.site_network.centers, atol=1e-5)


def test_triclinic_end_to_end():
    """Full pipeline on a sheared (triclinic) cell: general-cell XLA path +
    auto-calibrated cutoff still recover the hopping physics."""
    from sitator_tpu.core.structure import Structure
    from sitator_tpu.landmark import suggest_cutoff
    from sitator_tpu.dynamics import JumpAnalysis, MergeSitesByDynamics, \
        RemoveShortJumps

    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=600,
                                 jump_rate=0.03, seed=13)
    # shear the whole system (cell + all positions) — a genuine triclinic MD
    S = np.array([[1.0, 0.18, 0.0], [0.0, 1.0, 0.12], [0.0, 0.0, 1.0]])
    cell_t = md.structure.cell @ S
    traj_t = md.traj @ S.astype(md.traj.dtype)
    s_t = Structure(md.structure.positions @ S, md.structure.species, cell_t)
    sn = SiteNetwork(s_t, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn)

    midpoint, steepness = suggest_cutoff(seeds, traj_t)
    la = LandmarkAnalysis(cutoff_midpoint=midpoint,
                          cutoff_steepness=steepness, verbose=False)
    st = la.run(seeds, traj_t)
    st = MergeSitesByDynamics(distance_threshold=2.0, verbose=False).run(st)
    st = RemoveShortJumps(verbose=False).run(st)
    ja = JumpAnalysis(verbose=False)
    ja.run(st)

    # site recovery against the sheared true sites
    calc = PBCCalculator(cell_t)
    true_sites_t = md.true_sites @ S
    d = calc.pairwise_distances(st.site_network.centers, true_sites_t)
    site_map = d.argmin(axis=1)
    mapped = np.where(st.traj >= 0, site_map[st.traj], -1)
    assert (mapped == md.true_assignments).mean() > 0.95
    n_true = md.true_n_ij.sum()
    assert abs(ja.n_jumps - n_true) <= max(3, 0.15 * n_true)


@pytest.mark.parametrize("seed", range(6))
def test_kernel_trio_fuzz(seed):
    """Fuzz: random ragged bases / cells / params — the three assignment
    paths (dense XLA, gather, tiled with its Pallas lv kernel in interpret
    mode) must agree exactly on labels (all f32)."""
    import jax.numpy as jnp
    from sitator_tpu.ops import landmark as lmops
    from sitator_tpu.ops.landmark_mxu import (mxu_assign_blocks,
                                              permute_centers,
                                              prepare_mxu_basis)
    from sitator_tpu.ops.landmark_gather import gather_assign_blocks
    from sitator_tpu.ops.pbc import kernel_cell
    r = np.random.default_rng(100 + seed)
    B = int(r.integers(1, 4))
    M = int(r.integers(2, 12))
    N = int(r.integers(15, 60))
    S = int(r.integers(5, 200))
    V = int(r.integers(2, 9))
    K = int(r.integers(2, 12))
    L = float(r.uniform(8, 16))
    cell = np.diag([L, L * 1.1, L * 0.9]).astype(np.float32)
    if seed % 2:
        cell[1, 0] = 0.2 * L  # triclinic
    frac = r.random((B, M + N, 3)).astype(np.float32)
    pos = frac @ cell
    mobile, static = pos[:, :M], pos[:, M:]
    verts = np.stack([r.choice(N, V, replace=False)
                      for _ in range(S)]).astype(np.int32)
    vmask = r.random((S, V)) < 0.85
    vmask[:, 0] = True
    centers = r.random((K, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    midpoint = float(r.uniform(2.0, 4.5))
    steepness = float(r.uniform(2.0, 8.0))
    thr = float(r.uniform(0.1, 0.5))
    shape = "logistic_r2" if seed % 3 else "logistic"

    A = lmops.vertex_membership_matrix(verts, vmask, N)
    lv = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), np.float32), midpoint, steepness,
        cutoff_shape=shape)
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    lab_x, conf_x = lmops.assign_to_centers(
        lvn, jnp.asarray(centers), jnp.ones(K, bool), thr)

    kc = kernel_cell(cell)
    lab_g, conf_g = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), kc, jnp.asarray(centers), midpoint=midpoint,
        steepness=steepness, threshold=thr, mxu_bf16=False,
        cutoff_shape=shape)
    np.testing.assert_array_equal(np.asarray(lab_x), np.asarray(lab_g))
    np.testing.assert_allclose(np.asarray(conf_x), np.asarray(conf_g),
                               atol=3e-5)

    site_pos = static[0][verts].mean(axis=1)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    lab_m, conf_m = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis, kc,
        permute_centers(centers, basis), midpoint=midpoint,
        steepness=steepness, threshold=thr, mxu_bf16=False,
        interpret=True, cutoff_shape=shape)
    np.testing.assert_array_equal(np.asarray(lab_x), np.asarray(lab_m))
    np.testing.assert_allclose(np.asarray(conf_x), np.asarray(conf_m),
                               atol=3e-5)
