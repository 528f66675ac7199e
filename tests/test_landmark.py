"""Landmark engine: numpy oracle vs the landmark paths, clustering, end-to-end
physics recovery on synthetic MD (SURVEY.md §5 items 1-3)."""
import numpy as np
import pytest

import jax.numpy as jnp

from sitator_tpu import SiteNetwork
from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.landmark import LandmarkAnalysis, ZeroLandmarkError, \
    StaticLatticeError
from sitator_tpu.ops import landmark as lmops
from sitator_tpu.ops.cluster import dotprod_fit
from sitator_tpu.ops.pbc import PBCCalculator
from sitator_tpu.voronoi import VoronoiSiteGenerator


# ---------------------------------------------------------------- oracle --
def oracle_landmark_vectors(mobile, static, verts_list, cell, midpoint,
                            steepness):
    """Pure-NumPy float64 reimplementation of the landmark math from the
    paper / SURVEY.md §4.1: per (frame, ion, site), the product over the
    site's vertex atoms of the logistic cutoff of the min-image distance."""
    cell_inv = np.linalg.inv(cell)
    F, M, _ = mobile.shape
    S = len(verts_list)
    out = np.zeros((F, M, S))
    for f in range(F):
        for m in range(M):
            for s, verts in enumerate(verts_list):
                prod = 1.0
                for v in verts:
                    d = mobile[f, m] - static[f, v]
                    df = d @ cell_inv
                    df -= np.round(df)
                    dist = np.linalg.norm(df @ cell)
                    prod *= 1.0 / (1.0 + np.exp(steepness * (dist - midpoint)))
                out[f, m, s] = prod
    return out


def test_landmark_vectors_match_oracle(rng):
    cell = np.diag([9.0, 10.0, 11.0])
    F, M, N, S = 3, 4, 12, 5
    mobile = rng.uniform(0, 9, size=(F, M, 3))
    static = rng.uniform(0, 9, size=(F, N, 3))
    verts_list = [rng.choice(N, size=rng.integers(3, 6), replace=False)
                  for _ in range(S)]
    want = oracle_landmark_vectors(mobile, static, verts_list, cell,
                                   midpoint=3.0, steepness=4.0)

    vmax = max(len(v) for v in verts_list)
    verts = np.zeros((S, vmax), np.int32)
    vmask = np.zeros((S, vmax), bool)
    for i, v in enumerate(verts_list):
        verts[i, :len(v)] = v
        vmask[i, :len(v)] = True
    A = lmops.vertex_membership_matrix(verts, vmask, N)
    got = lmops.landmark_vectors(
        jnp.asarray(mobile, jnp.float32), jnp.asarray(static, jnp.float32),
        A, jnp.asarray(cell, jnp.float32),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)


def test_landmark_repeated_vertex_multiplicity(rng):
    """An atom listed twice among a site's vertices squares its factor."""
    cell = np.eye(3) * 8.0
    mobile = rng.uniform(0, 8, size=(1, 1, 3))
    static = rng.uniform(0, 8, size=(1, 4, 3))
    verts = np.array([[0, 0, 1]], np.int32)
    vmask = np.ones((1, 3), bool)
    A = lmops.vertex_membership_matrix(verts, vmask, 4)
    assert A[0, 0] == 2.0
    got = lmops.landmark_vectors(
        jnp.asarray(mobile, jnp.float32), jnp.asarray(static, jnp.float32),
        A, jnp.asarray(cell, jnp.float32),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 2.0)
    want = oracle_landmark_vectors(mobile, static, [np.array([0, 0, 1])],
                                   cell, 3.0, 2.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


def test_peak_even_clip():
    lv = jnp.asarray([[0.9, 0.5, 0.1], [0.2, 0.2, 0.2]])
    out = np.asarray(lmops.peak_even(lv, "clip"))
    np.testing.assert_allclose(out, [[0.5, 0.5, 0.1], [0.2, 0.2, 0.2]])


def test_normalize_zero_rows():
    lv = jnp.asarray([[0.0, 0.0], [3.0, 4.0]])
    out, norms = lmops.normalize_landmark_vectors(lv)
    np.testing.assert_allclose(np.asarray(norms), [0.0, 5.0])
    np.testing.assert_allclose(np.asarray(out), [[0, 0], [0.6, 0.8]])


# ------------------------------------------------------------- clustering --
def _clustered_unit_vectors(rng, n_per, centers_idx, D, noise=0.05):
    X = []
    labels = []
    for i, c in enumerate(centers_idx):
        base = np.zeros(D)
        base[c] = 1.0
        pts = base[None] + rng.normal(scale=noise, size=(n_per, D))
        X.append(np.abs(pts))
        labels += [i] * n_per
    X = np.concatenate(X)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return X.astype(np.float32), np.array(labels)


def test_dotprod_fit_recovers_clusters(rng):
    X, true = _clustered_unit_vectors(rng, 200, [0, 3, 7], D=10)
    perm = rng.permutation(len(X))
    res = dotprod_fit(jnp.asarray(X[perm]), k_max=16, cluster_threshold=0.8,
                      min_samples=20)
    assert res.n_clusters == 3
    labels, confs = lmops.assign_to_centers(
        jnp.asarray(X), res["centers"], res["active"], 0.5)
    labels = np.asarray(labels)
    # permutation-consistent exact recovery
    for t in range(3):
        lab = labels[true == t]
        assert len(np.unique(lab)) == 1 and lab[0] >= 0
    assert np.asarray(confs).min() > 0.8


def test_dotprod_min_samples_drops_tiny_clusters(rng):
    X, true = _clustered_unit_vectors(rng, 100, [0, 4], D=8)
    X2, _ = _clustered_unit_vectors(rng, 3, [6], D=8)  # tiny cluster
    allX = np.concatenate([X, X2])
    res = dotprod_fit(jnp.asarray(allX), k_max=8, cluster_threshold=0.8,
                      min_samples=10)
    assert res.n_clusters == 2


def test_dotprod_zero_rows_never_seed(rng):
    X, _ = _clustered_unit_vectors(rng, 50, [1], D=6)
    X[10] = 0.0
    X[30] = 0.0
    res = dotprod_fit(jnp.asarray(X), k_max=4, cluster_threshold=0.8,
                      min_samples=5)
    assert res.n_clusters == 1


# ------------------------------------------------------------- end-to-end --
@pytest.fixture(scope="module")
def synthetic_run():
    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=800,
                                 jump_rate=0.02, sigma_mobile=0.25,
                                 sigma_static=0.04, seed=42)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    la = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          minimum_site_occupancy=0.01)
    st = la.run(seeds, md.traj)
    return md, seeds, la, st


def test_end_to_end_site_recovery(synthetic_run):
    """Parity gate 1 (BASELINE.md): every well-visited ground-truth site is
    discovered, every discovered site sits on a truly visited site, and raw
    landmark analysis may only over-split modestly (the reference pipeline
    fixes over-splitting downstream with MergeSitesByDynamics)."""
    md, seeds, la, st = synthetic_run
    sn = st.site_network
    calc = PBCCalculator(md.structure.cell)

    visited, visits = np.unique(md.true_assignments, return_counts=True)
    well_visited = visited[visits >= 16]   # 2x the occupancy threshold
    d_wv = calc.pairwise_distances(sn.centers, md.true_sites[well_visited])
    # every well-visited true site has a discovered site within 0.5 A
    assert d_wv.min(axis=0).max() < 0.5
    # every discovered site sits on SOME truly visited site (no phantoms)
    d_v = calc.pairwise_distances(sn.centers, md.true_sites[visited])
    assert d_v.min(axis=1).max() < 0.5
    # bounded over-splitting
    assert sn.n_sites <= int(1.3 * len(visited))


def test_end_to_end_assignment_accuracy(synthetic_run):
    """Frame-by-frame assignments match ground truth through the site map."""
    md, seeds, la, st = synthetic_run
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(st.site_network.centers, md.true_sites)
    site_map = d.argmin(axis=1)          # discovered -> true
    mapped = np.where(st.traj >= 0, site_map[st.traj], -1)
    agree = mapped == md.true_assignments
    assert agree.mean() > 0.97
    assert st.percent_unassigned < 0.02


def test_end_to_end_landmark_vectors_exposed(synthetic_run):
    md, seeds, la, st = synthetic_run
    lv = la.landmark_vectors
    assert lv.shape == (md.n_frames * md.n_ions, la.landmark_dimension)
    assert la.landmark_dimension == seeds.n_sites
    # vectors are normalized (or zero)
    norms = np.linalg.norm(lv, axis=1)
    assert np.all((np.abs(norms - 1) < 1e-4) | (norms == 0))


def test_static_drift_detection(synthetic_run):
    md, seeds, la, st = synthetic_run
    bad = md.traj.copy()
    bad[400:, 0] += 3.0  # a "static" atom wanders off
    la2 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                           static_movement_threshold=1.0)
    with pytest.raises(StaticLatticeError):
        la2.run(seeds, bad)


def test_dynamic_lattice_mapping_recovers_swap(synthetic_run):
    """Two static atoms exchange lattice sites mid-trajectory: with
    dynamic_lattice_mapping the analysis follows the lattice and recovers
    IDENTICAL sites/assignments/jumps as the unswapped run; without it,
    StaticLatticeError (VERDICT r1 item 3)."""
    md, seeds, la, st = synthetic_run
    swapped = md.traj.copy()
    static_atoms = np.flatnonzero(md.static_mask)
    i, j = static_atoms[2], static_atoms[17]
    T = 389  # not on a block boundary (batch_frames=256)
    swapped[T:, i], swapped[T:, j] = (md.traj[T:, j].copy(),
                                      md.traj[T:, i].copy())

    la_plain = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                                static_movement_threshold=1.0, verbose=False)
    with pytest.raises(StaticLatticeError):
        la_plain.run(seeds, swapped)

    la_dyn = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                              static_movement_threshold=1.0,
                              dynamic_lattice_mapping=True, verbose=False)
    st_dyn = la_dyn.run(seeds, swapped)
    # slot->atom map records exactly the swap
    perm = la_dyn.lattice_mapping_
    si = np.flatnonzero(static_atoms == i)[0]
    sj = np.flatnonzero(static_atoms == j)[0]
    assert perm[si] == sj and perm[sj] == si
    assert (perm == np.arange(len(perm))).sum() == len(perm) - 2
    # swapping static-atom IDENTITIES does not change the physics: the
    # remapped landmark basis reproduces the unswapped analysis exactly
    np.testing.assert_array_equal(st_dyn.traj, st.traj)
    np.testing.assert_allclose(st_dyn.site_network.centers,
                               st.site_network.centers, atol=1e-5)
    # a swap that strands an atom between sites has no consistent mapping
    broken = md.traj.copy()
    broken[T:, i] += 2.0  # drifts off, but no vacated site to claim
    with pytest.raises(StaticLatticeError):
        la_dyn2 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                                   static_movement_threshold=1.0,
                                   dynamic_lattice_mapping=True,
                                   verbose=False)
        la_dyn2.run(seeds, broken)


def test_zero_landmark_detection(synthetic_run):
    md, seeds, la, st = synthetic_run
    bad = md.traj.copy()
    # an ion teleports far from every landmark polyhedron with a tight cutoff
    la2 = LandmarkAnalysis(cutoff_midpoint=1.0, cutoff_steepness=30.0)
    with pytest.raises(ZeroLandmarkError):
        la2.run(seeds, bad)
    # warn-only mode must not raise
    la3 = LandmarkAnalysis(cutoff_midpoint=1.0, cutoff_steepness=30.0,
                           check_for_zero_landmarks=False,
                           minimum_site_occupancy=0.0)
    try:
        la3.run(seeds, bad)
    except ZeroLandmarkError:
        pytest.fail("check_for_zero_landmarks=False must not raise")
    except Exception:
        pass  # all-zero vectors may legitimately yield no sites


def test_mcl_clustering_backend(synthetic_run):
    """The MCL backend is a drop-in clustering_algorithm and recovers the
    same site structure (within splitting tolerance)."""
    md, seeds, la, st = synthetic_run
    la2 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                           clustering_algorithm="mcl", verbose=False)
    st2 = la2.run(seeds, md.traj)
    sn2 = st2.site_network
    calc = PBCCalculator(md.structure.cell)
    visited = np.unique(md.true_assignments)
    d = calc.pairwise_distances(sn2.centers, md.true_sites[visited])
    # every discovered site sits on a truly visited site
    assert d.min(axis=1).max() < 1.0
    # assignments mostly valid
    assert st2.percent_unassigned < 0.10


def test_cutoff_r2_matches_oracle(rng):
    """The d^2-logistic fast cutoff matches its own float64 oracle and
    agrees with the standard logistic at the midpoint."""
    cell = np.diag([9.0, 10.0, 11.0])
    F, M, N, S = 2, 3, 10, 4
    mobile = rng.uniform(0, 9, size=(F, M, 3))
    static = rng.uniform(0, 9, size=(F, N, 3))
    verts_list = [rng.choice(N, size=4, replace=False) for _ in range(S)]
    k, d0 = 3.0, 4.0

    # float64 oracle of the r2 variant
    cell_inv = np.linalg.inv(cell)
    want = np.zeros((F, M, S))
    k2 = k / (2 * d0)
    for f in range(F):
        for m in range(M):
            for s, vv in enumerate(verts_list):
                prod = 1.0
                for v in vv:
                    d = mobile[f, m] - static[f, v]
                    df = d @ cell_inv
                    df -= np.round(df)
                    d2 = np.sum((df @ cell) ** 2)
                    prod *= 1.0 / (1.0 + np.exp(k2 * (d2 - d0 * d0)))
                want[f, m, s] = prod

    vmax = 4
    verts = np.stack(verts_list).astype(np.int32)
    vmask = np.ones((S, vmax), bool)
    A = lmops.vertex_membership_matrix(verts, vmask, N)
    got = lmops.landmark_vectors(
        jnp.asarray(mobile, jnp.float32), jnp.asarray(static, jnp.float32),
        A, jnp.asarray(cell, jnp.float32),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), d0, k,
        cutoff_shape="logistic_r2")
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)
    # both cutoffs equal 1/2 exactly at d = midpoint
    c_log = np.exp(np.asarray(lmops.log_cutoff(jnp.asarray(d0), d0, k)))
    c_r2 = np.exp(np.asarray(lmops.log_cutoff_r2(jnp.asarray(d0 * d0),
                                                 d0, k)))
    assert abs(c_log - 0.5) < 1e-6 and abs(c_r2 - 0.5) < 1e-6


def test_landmark_analysis_r2_cutoff_end_to_end(synthetic_run):
    """cutoff_shape='logistic_r2' recovers the same physics."""
    md, seeds, la, st = synthetic_run
    la2 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                           cutoff_shape="logistic_r2", verbose=False)
    st2 = la2.run(seeds, md.traj)
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(st2.site_network.centers, md.true_sites)
    site_map = d.argmin(axis=1)
    mapped = np.where(st2.traj >= 0, site_map[st2.traj], -1)
    assert (mapped == md.true_assignments).mean() > 0.97


def test_multiple_occupancy_warning(synthetic_run, caplog):
    """max_mobile_per_site violations surface as a warning."""
    import logging
    md, seeds, la, st = synthetic_run
    # force two ions onto one site by duplicating an ion's coordinates
    bad = md.traj.copy()
    mobile_idx = np.flatnonzero(md.mobile_mask)
    bad[:, mobile_idx[1]] = bad[:, mobile_idx[0]]
    la2 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                           verbose=False)
    with caplog.at_level(logging.WARNING,
                         logger="sitator_tpu.landmark.analysis"):
        la2.run(seeds, bad)
    assert any("max_mobile_per_site" in r.message for r in caplog.records)


def test_suggest_cutoff_recovers_physics(synthetic_run):
    """Auto-calibrated cutoff parameters drive the pipeline to the same
    ground-truth recovery as the hand-tuned ones."""
    from sitator_tpu.landmark import suggest_cutoff
    md, seeds, la, st = synthetic_run
    midpoint, steepness = suggest_cutoff(seeds, md.traj)
    assert 3.0 < midpoint < 6.5
    assert 1.0 <= steepness <= 10.0
    la2 = LandmarkAnalysis(cutoff_midpoint=midpoint,
                           cutoff_steepness=steepness, verbose=False)
    st2 = la2.run(seeds, md.traj)
    calc = PBCCalculator(md.structure.cell)
    d = calc.pairwise_distances(st2.site_network.centers, md.true_sites)
    site_map = d.argmin(axis=1)
    mapped = np.where(st2.traj >= 0, site_map[st2.traj], -1)
    assert (mapped == md.true_assignments).mean() > 0.95


def test_clustering_robust_to_subunit_rows():
    """A row whose norm is below the clustering threshold can never be
    covered (sim <= |x|); it must end unassigned WITHOUT poisoning the
    seeding pass (review finding r4-late: a 0.35-norm first row re-seeded
    itself k_max times and every cluster count came back zero)."""
    from sitator_tpu.landmark.cluster.dotprod import do_landmark_clustering
    rng = np.random.default_rng(3)
    a = np.zeros(12); a[0] = 1.0
    b = np.zeros(12); b[5] = 1.0
    rows = [0.3 * (a + 0.01)]     # uncoverable (< both thresholds), FIRST
    for _ in range(60):
        for base in (a, b):
            v = base + rng.normal(scale=0.03, size=12)
            rows.append(v / np.linalg.norm(v))
    X = np.asarray(rows, np.float32)
    counts, labels, confs, centers = do_landmark_clustering(
        X, None, 5, verbose=False)
    assert len(counts) == 2, counts
    assert labels[0] == -1                        # weak row unassigned
    assert (labels[1:] >= 0).all()
    assert sorted(counts.tolist()) == [60, 60]


def test_zero_landmark_detector_catches_subeps_norms():
    """Raw landmark norms below the normalize floor (1e-12) count as
    'saw no landmark' — an exact ==0 test let ~1e-13 rows through as
    sub-unit garbage (review finding r4-late)."""
    from sitator_tpu import SiteNetwork
    from sitator_tpu.io import make_hopping_trajectory
    from sitator_tpu.util.errors import ZeroLandmarkError
    from sitator_tpu.voronoi import VoronoiSiteGenerator
    md = make_hopping_trajectory(n_cells=2, a=4.0, n_ions=2,
                                 n_frames=40, jump_rate=0.02, seed=2)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn = VoronoiSiteGenerator(verbose=False).run(sn)
    # a cutoff so tight the product is ~e^{-large} but not exactly 0
    with pytest.raises(ZeroLandmarkError):
        LandmarkAnalysis(cutoff_midpoint=0.4, cutoff_steepness=12.0,
                         verbose=False).run(sn, md.traj)


def test_mcl_backend_min_samples_prunes_to_empty():
    """When every MCL group is smaller than min_samples the backend
    returns zero centers and all-unassigned labels (verbose path
    included) instead of crashing on an empty stack (coverage audit)."""
    from sitator_tpu.landmark.cluster.mcl import do_landmark_clustering
    rng = np.random.default_rng(4)
    a = np.zeros(8); a[0] = 1.0
    b = np.zeros(8); b[4] = 1.0
    rows = []
    for _ in range(10):
        for base in (a, b):
            v = base + rng.normal(scale=0.02, size=8)
            rows.append(v / np.linalg.norm(v))
    X = np.asarray(rows, np.float32)
    counts, labels, confs, centers = do_landmark_clustering(
        X, None, min_samples=1000, verbose=True)
    assert len(counts) == 0 and len(centers) == 0
    assert (labels == -1).all()
    assert (confs == 0).all()


def test_dynamic_mapping_verbose_and_find_mapping_identity(synthetic_run):
    """The verbose remap path logs slot counts; _find_lattice_mapping
    returns the permutation unchanged when nothing exceeds the
    threshold in f64 (coverage audit)."""
    md, seeds, la, st = synthetic_run
    swapped = md.traj.copy()
    static_atoms = np.flatnonzero(md.static_mask)
    i, j = static_atoms[2], static_atoms[17]
    swapped[389:, i], swapped[389:, j] = (md.traj[389:, j].copy(),
                                          md.traj[389:, i].copy())
    la_dyn = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                              static_movement_threshold=1.0,
                              dynamic_lattice_mapping=True, verbose=True)
    st_dyn = la_dyn.run(seeds, swapped)
    np.testing.assert_array_equal(st_dyn.traj, st.traj)

    # identity case: no slot exceeds threshold -> same perm, max dist
    ref = md.traj[0][md.static_mask]
    perm = np.arange(len(ref))
    out, worst = LandmarkAnalysis._find_lattice_mapping(
        ref, perm, ref, md.structure.cell, 1.0)
    np.testing.assert_array_equal(out, perm)
    assert worst == 0.0


def test_dynamic_mapping_graze_accept_and_nonconvergence(synthetic_run,
                                                         monkeypatch):
    """Two defensive corners of the remap loop, pinned by forcing the
    host-side matcher's answer: (a) when the f64 matcher finds no
    offenders (f32 drift grazed the threshold) the frame is ACCEPTED —
    no infinite remap loop; (b) a matcher that keeps changing the
    permutation without fixing the offending frame raises the
    did-not-converge StaticLatticeError instead of spinning."""
    md, seeds, la, st = synthetic_run
    bad = md.traj.copy()
    static_atoms = np.flatnonzero(md.static_mask)
    bad[389:, static_atoms[5]] += 1.6      # real drift above thr=1.0

    # (a) matcher says "same perm": frames must be accepted and the run
    # completes (the drifted atom simply keeps its slot)
    monkeypatch.setattr(
        LandmarkAnalysis, "_remap_lattice",
        lambda self, static_pos, perm, static_ref, cell, frame:
            perm.copy())
    la_a = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                            static_movement_threshold=1.0,
                            dynamic_lattice_mapping=True, verbose=False)
    st_a = la_a.run(seeds, bad)
    assert st_a.traj.shape == st.traj.shape
    monkeypatch.undo()

    # (b) matcher cycles permutations that never fix the frame
    def cycling(self, static_pos, perm, static_ref, cell, frame):
        new = perm.copy()
        new[0], new[1] = perm[1], perm[0]   # always != current perm
        return new
    monkeypatch.setattr(LandmarkAnalysis, "_remap_lattice", cycling)
    la_b = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                            static_movement_threshold=1.0,
                            dynamic_lattice_mapping=True, verbose=False)
    with pytest.raises(StaticLatticeError, match="did not converge"):
        la_b.run(seeds, bad)


def test_multiple_occupancy_ignore(synthetic_run):
    """multiple_occupancy_action='ignore' skips the check entirely
    (coverage audit)."""
    import logging
    md, seeds, la, st = synthetic_run
    bad = md.traj.copy()
    mobile_idx = np.flatnonzero(md.mobile_mask)
    bad[:, mobile_idx[1]] = bad[:, mobile_idx[0]]
    la2 = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                           multiple_occupancy_action="ignore",
                           verbose=False)
    st2 = la2.run(seeds, bad)       # no warning, no raise
    assert st2.traj.shape[0] == md.traj.shape[0]


def test_ops_validation_and_reduced_precision_paths():
    """Unknown cutoff_shape / peak_evening raise; the opt-in
    matmul_dtype casts run and stay close to the f32 result
    (coverage audit)."""
    import jax.numpy as jnp
    from sitator_tpu.ops import landmark as lmops
    rng = np.random.default_rng(5)
    B, M, N, S = 2, 3, 8, 4
    cell = np.eye(3, dtype=np.float32) * 8.0
    mobile = rng.uniform(0, 8, (B, M, 3)).astype(np.float32)
    static = rng.uniform(0, 8, (B, N, 3)).astype(np.float32)
    A = (rng.random((N, S)) < 0.5).astype(np.float32)
    kw = dict(cell=jnp.asarray(cell), cell_inv=jnp.linalg.inv(cell),
              midpoint=2.0, steepness=3.0)
    with pytest.raises(ValueError, match="cutoff_shape"):
        lmops.landmark_vectors(mobile, static, A,
                               cutoff_shape="gauss", **kw)
    f32 = np.asarray(lmops.landmark_vectors(mobile, static, A, **kw))
    bf16 = np.asarray(lmops.landmark_vectors(
        mobile, static, A, matmul_dtype=jnp.bfloat16, **kw))
    np.testing.assert_allclose(bf16, f32, atol=0.05)
    with pytest.raises(ValueError, match="peak_evening"):
        lmops.peak_even(jnp.ones((2, 3)), "sqrt")
    lvn = f32.reshape(-1, S)
    lvn = lvn / np.maximum(np.linalg.norm(lvn, axis=1, keepdims=True),
                           1e-12)
    # centers: the least-parallel pair of rows, so each is its own best
    # match by a margin far above bf16 rounding (two nearly parallel rows
    # would tie within bf16 epsilon)
    cos = lvn @ lvn.T
    i, j = np.unravel_index(np.argmin(cos), cos.shape)
    assert cos[i, j] < 0.9
    centers = lvn[[i, j]]
    lab32, _ = lmops.assign_to_centers(
        jnp.asarray(lvn), jnp.asarray(centers), jnp.ones(2, bool), 0.5)
    lab16, _ = lmops.assign_to_centers(
        jnp.asarray(lvn), jnp.asarray(centers), jnp.ones(2, bool), 0.5,
        matmul_dtype=jnp.bfloat16)
    # random near-tie rows may flip under bf16; the center rows are their
    # own centers with sim 1.0 and must agree exactly
    assert np.asarray(lab16)[i] == np.asarray(lab32)[i] == 0
    assert np.asarray(lab16)[j] == np.asarray(lab32)[j] == 1
    assert set(np.unique(np.asarray(lab16))) <= {-1, 0, 1}
