"""Tiled landmark path (Pallas-Triton lv kernel in interpret mode, and its
plain-jnp twin) vs the dense XLA formulation and the gather path, plus the
backend-neutral path choice."""
import numpy as np
import pytest

import jax.numpy as jnp

from sitator_tpu.ops import landmark as lmops
from sitator_tpu.ops.landmark_mxu import (
    mxu_assign_blocks,
    mxu_supported,
    permute_centers,
    prepare_mxu_basis,
)
from sitator_tpu.ops.landmark_gather import gather_assign_blocks


def _system(rng, B=2, M=7, N=40, S=20, V=5, K=6, L=11.0, cell=None):
    if cell is None:
        cell = np.diag([L, L + 1, L + 2]).astype(np.float32)
    frac = rng.random((B, M + N, 3)).astype(np.float32)
    pos = frac @ cell
    mobile, static = pos[:, :M], pos[:, M:]
    verts = np.stack([rng.choice(N, V, replace=False)
                      for _ in range(S)]).astype(np.int32)
    vmask = rng.random((S, V)) < 0.8
    vmask[:, 0] = True
    centers = rng.random((K, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    # site positions for Morton ordering: mean vertex position (frame 0)
    site_pos = static[0][verts].mean(axis=1)
    return cell, mobile, static, verts, vmask, centers, site_pos


def _xla_reference(cell, mobile, static, verts, vmask, centers, thr,
                   cutoff_shape="logistic", peak_evening="none"):
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    lv = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0,
        cutoff_shape=cutoff_shape)
    lv = lmops.peak_even(lv, peak_evening)
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    return lmops.assign_to_centers(lvn, jnp.asarray(centers),
                                   jnp.ones(len(centers), bool), thr)


@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_mxu_kernel_matches_xla(rng, cutoff_shape):
    r = np.random.default_rng(11)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(r)
    want_lab, want_conf = _xla_reference(cell, mobile, static, verts,
                                         vmask, centers, 0.3,
                                         cutoff_shape=cutoff_shape)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got_lab, got_conf = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis,
        jnp.asarray(np.diag(cell).astype(np.float32)),
        permute_centers(centers, basis), midpoint=3.0, steepness=4.0,
        threshold=0.3, mxu_bf16=False, interpret=True,
        cutoff_shape=cutoff_shape)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=2e-5)


def test_mxu_kernel_triclinic(rng):
    r = np.random.default_rng(13)
    L = 11.0
    cell = np.array([[L, 0, 0],
                     [0.25 * L, L + 1, 0],
                     [-0.15 * L, 0.2 * L, L + 2]], np.float32)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, cell=cell)
    want_lab, want_conf = _xla_reference(cell, mobile, static, verts,
                                         vmask, centers, 0.3)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got_lab, got_conf = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis,
        jnp.asarray(cell), permute_centers(centers, basis),
        midpoint=3.0, steepness=4.0, threshold=0.3, mxu_bf16=False,
        interpret=True)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=2e-5)


def test_mxu_kernel_peak_clip(rng):
    r = np.random.default_rng(17)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=200)  # 200 sites -> 2 tiles at s_tile=128: cross-tile top-2
    want_lab, want_conf = _xla_reference(cell, mobile, static, verts,
                                         vmask, centers, 0.3,
                                         peak_evening="clip")
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got_lab, got_conf = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis,
        jnp.asarray(np.diag(cell).astype(np.float32)),
        permute_centers(centers, basis), midpoint=3.0, steepness=4.0,
        threshold=0.3, mxu_bf16=False, interpret=True,
        peak_evening="clip")
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=2e-5)


def test_mxu_kernel_vertex_multiplicity(rng):
    """A repeated vertex index must square its factor (A multiplicity)."""
    r = np.random.default_rng(19)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(r)
    verts = verts.copy()
    verts[0, 1] = verts[0, 0]  # duplicate vertex in site 0
    vmask = np.ones_like(vmask)
    want_lab, want_conf = _xla_reference(cell, mobile, static, verts,
                                         vmask, centers, 0.3)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got_lab, got_conf = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis,
        jnp.asarray(np.diag(cell).astype(np.float32)),
        permute_centers(centers, basis), midpoint=3.0, steepness=4.0,
        threshold=0.3, mxu_bf16=False, interpret=True)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=2e-5)


def test_mxu_matches_gather_kernel(rng):
    """Same labels as the gather path (both f32)."""
    r = np.random.default_rng(23)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=150, K=8)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    diag = jnp.asarray(np.diag(cell).astype(np.float32))
    la, ca = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis, diag,
        permute_centers(centers, basis), midpoint=3.0, steepness=4.0,
        threshold=0.3, mxu_bf16=False, interpret=True,
        cutoff_shape="logistic_r2")
    lb, cb = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), diag, jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.3, mxu_bf16=False,
        cutoff_shape="logistic_r2")
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_allclose(np.asarray(ca), np.asarray(cb), atol=2e-5)


def test_mxu_supported_cost_gate():
    # SC-like shared-vertex basis: supported
    rng = np.random.default_rng(3)
    n = 64
    verts = np.stack([rng.choice(12, 5, replace=False)
                      for _ in range(n)]).astype(np.int32)  # heavy sharing
    vmask = np.ones_like(verts, dtype=bool)
    site_pos = rng.random((n, 3)) * 10
    basis = prepare_mxu_basis(verts, vmask, site_pos, np.eye(3) * 10,
                              s_tile=64)
    assert mxu_supported(basis)
    # adversarial no-sharing basis: every site its own atoms
    verts2 = np.arange(n * 5, dtype=np.int32).reshape(n, 5)
    basis2 = prepare_mxu_basis(verts2, vmask, site_pos, np.eye(3) * 10,
                               s_tile=64)
    assert not mxu_supported(basis2)


def _sc_system(n_c=20, a=4.0, M=6, B=2, K=8, seed=23):
    """Structured simple-cubic lattice: sites at cell centers, verts = the
    8 surrounding lattice atoms — the geometry the tiled path is built
    for (spatially compact kd tiles)."""
    r = np.random.default_rng(seed)
    L = n_c * a
    cell = np.eye(3, dtype=np.float32) * L
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    static0 = grid * a + r.normal(scale=0.05, size=(len(grid), 3))
    site_pos = (grid + 0.5) * a

    def idx(v):
        v = v % n_c
        return v[:, 0] * n_c * n_c + v[:, 1] * n_c + v[:, 2]

    verts = np.stack([idx(grid + d) for d in
                      np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                           indexing="ij"), -1).reshape(-1, 3)
                      ], axis=1).astype(np.int32)
    vmask = np.ones_like(verts, dtype=bool)
    static = np.broadcast_to(static0, (B,) + static0.shape).copy()
    static += r.normal(scale=0.03, size=static.shape)
    mobile = r.random((B, M, 3)) * L
    centers = r.random((K, len(site_pos))).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return (cell, mobile.astype(np.float32), static.astype(np.float32),
            verts, vmask, centers, site_pos)


def test_mxu_preshift_activates_and_matches(rng):
    """Tile-preshift route: activates on a large structured cell
    (logistic_r2 underflow bound met) and reproduces the per-pair path's
    labels; confidences agree to fp tolerance."""
    cell, mobile, static, verts, vmask, centers, site_pos = _sc_system()
    kw = dict(midpoint=3.0, steepness=4.0, threshold=0.3, mxu_bf16=False,
              interpret=True, cutoff_shape="logistic_r2")
    basis_ps = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=256,
        static_ref=np.asarray(static[0], np.float64),
        midpoint=3.0, steepness=4.0, cutoff_shape="logistic_r2")
    assert basis_ps["preshift"], "bound must hold on this geometry"
    basis_pp = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=256)
    assert not basis_pp["preshift"]

    cdiag = jnp.asarray(np.diag(cell).astype(np.float32))
    lab_ps, conf_ps = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis_ps, cdiag,
        permute_centers(centers, basis_ps), **kw)
    lab_pp, conf_pp = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis_pp, cdiag,
        permute_centers(centers, basis_pp), **kw)
    np.testing.assert_array_equal(np.asarray(lab_ps), np.asarray(lab_pp))
    np.testing.assert_allclose(np.asarray(conf_ps), np.asarray(conf_pp),
                               atol=2e-5)
    # and against the dense XLA oracle
    want_lab, want_conf = _xla_reference(cell, mobile, static, verts,
                                         vmask, centers, 0.3,
                                         cutoff_shape="logistic_r2")
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(lab_ps))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(conf_ps),
                               atol=2e-5)


def test_mxu_preshift_handles_wrapped_atoms(rng):
    """Per-frame atoms wrapped into a different image than the reference
    must be re-unwrapped at trace time (the shift is constant only modulo
    the cell)."""
    cell, mobile, static, verts, vmask, centers, site_pos = _sc_system(B=1)
    L = float(cell[0, 0])
    static_wrapped = np.mod(static + 0.5 * L, L) - 0.5 * L  # shift images
    kw = dict(midpoint=3.0, steepness=4.0, threshold=0.3, mxu_bf16=False,
              interpret=True, cutoff_shape="logistic_r2")
    basis_ps = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=256,
        static_ref=np.asarray(static[0], np.float64),
        midpoint=3.0, steepness=4.0, cutoff_shape="logistic_r2")
    assert basis_ps["preshift"]
    cdiag = jnp.asarray(np.diag(cell).astype(np.float32))
    lab_w, _ = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static_wrapped), basis_ps, cdiag,
        permute_centers(centers, basis_ps), **kw)
    lab_r, _ = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis_ps, cdiag,
        permute_centers(centers, basis_ps), **kw)
    np.testing.assert_array_equal(np.asarray(lab_w), np.asarray(lab_r))


def test_mxu_preshift_rejects_small_cells():
    """The underflow bound fails on a small cell -> per-pair fallback."""
    r = np.random.default_rng(29)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(r)
    basis = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=256,
        static_ref=np.asarray(static[0], np.float64),
        midpoint=3.0, steepness=4.0, cutoff_shape="logistic")
    assert not basis["preshift"]


@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_mxu_landmark_blocks_matches_xla(rng, cutoff_shape):
    """The lv-emitting kernel reproduces the dense XLA landmark vectors
    in the caller's site order (both preshift and per-pair routes)."""
    from sitator_tpu.ops.landmark_mxu import mxu_landmark_blocks
    cell, mobile, static, verts, vmask, centers, site_pos = _sc_system(
        n_c=8)  # small cell: per-pair route
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    want = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0,
        cutoff_shape=cutoff_shape)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got = mxu_landmark_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis,
        jnp.asarray(np.diag(cell).astype(np.float32)),
        midpoint=3.0, steepness=4.0, interpret=True,
        cutoff_shape=cutoff_shape)
    np.testing.assert_allclose(np.asarray(want), np.asarray(got),
                               atol=2e-6)


def test_mxu_landmark_blocks_preshift(rng):
    from sitator_tpu.ops.landmark_mxu import mxu_landmark_blocks
    cell, mobile, static, verts, vmask, centers, site_pos = _sc_system()
    basis = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=256,
        static_ref=np.asarray(static[0], np.float64),
        midpoint=3.0, steepness=4.0, cutoff_shape="logistic_r2")
    assert basis["preshift"]
    basis_pp = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=256)
    kw = dict(midpoint=3.0, steepness=4.0, interpret=True,
              cutoff_shape="logistic_r2")
    cdiag = jnp.asarray(np.diag(cell).astype(np.float32))
    lv_ps = mxu_landmark_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                basis, cdiag, **kw)
    lv_pp = mxu_landmark_blocks(jnp.asarray(mobile), jnp.asarray(static),
                                basis_pp, cdiag, **kw)
    np.testing.assert_allclose(np.asarray(lv_ps), np.asarray(lv_pp),
                               atol=1e-6)


def test_landmark_analysis_fused_path(rng):
    """LandmarkAnalysis(use_fused=True) reproduces the dense-path result
    end-to-end (sites, labels, exposed landmark_vectors)."""
    from sitator_tpu import SiteNetwork
    from sitator_tpu.io.synthetic import make_hopping_trajectory
    from sitator_tpu.landmark import LandmarkAnalysis
    from sitator_tpu.voronoi import VoronoiSiteGenerator

    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=150,
                                 jump_rate=0.02, seed=31)
    sn0 = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(sn0)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              minimum_site_occupancy=0.01, verbose=False)
    la_x = LandmarkAnalysis(use_fused=False, **kw)
    la_m = LandmarkAnalysis(use_fused=True, interpret=True, **kw)
    st_x = la_x.run(seeds, md.traj.astype(np.float32))
    st_m = la_m.run(seeds, md.traj.astype(np.float32))
    assert st_x.site_network.n_sites == st_m.site_network.n_sites
    agree = np.mean(st_x.traj == st_m.traj)
    assert agree > 0.995, agree
    np.testing.assert_allclose(la_x.landmark_vectors,
                               la_m.landmark_vectors, atol=5e-5)


def test_mxu_landmark_blocks_triclinic(rng):
    from sitator_tpu.ops.landmark_mxu import mxu_landmark_blocks
    r = np.random.default_rng(37)
    L = 11.0
    cell = np.array([[L, 0, 0],
                     [0.25 * L, L + 1, 0],
                     [-0.15 * L, 0.2 * L, L + 2]], np.float32)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, cell=cell)
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    want = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got = mxu_landmark_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis, jnp.asarray(cell),
        midpoint=3.0, steepness=4.0, interpret=True)
    np.testing.assert_allclose(np.asarray(want), np.asarray(got), atol=2e-6)


def test_mxu_preshift_robust_to_drift_within_budget(rng):
    """Static atoms drifted up to the guard threshold (inside the
    preshift vibration budget) must not change labels vs per-pair."""
    cell, mobile, static, verts, vmask, centers, site_pos = _sc_system(B=1)
    r = np.random.default_rng(41)
    # drift every atom by up to 1.0 A in a random direction (threshold
    # regime), on top of the thermal noise already present
    drift = r.normal(size=static.shape)
    drift *= 1.0 / np.linalg.norm(drift, axis=-1, keepdims=True)
    static_d = (static + drift * r.uniform(0, 1.0, size=static.shape[:-1]
                                           )[..., None]).astype(np.float32)
    kw = dict(midpoint=3.0, steepness=4.0, threshold=0.3, mxu_bf16=False,
              interpret=True, cutoff_shape="logistic_r2")
    basis_ps = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=256,
        static_ref=np.asarray(static[0], np.float64),
        midpoint=3.0, steepness=4.0, cutoff_shape="logistic_r2",
        vibration_margin=2.0)
    assert basis_ps["preshift"]
    basis_pp = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=256)
    cdiag = jnp.asarray(np.diag(cell).astype(np.float32))
    lab_ps, _ = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static_d), basis_ps, cdiag,
        permute_centers(centers, basis_ps), **kw)
    lab_pp, _ = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static_d), basis_pp, cdiag,
        permute_centers(centers, basis_pp), **kw)
    np.testing.assert_array_equal(np.asarray(lab_ps), np.asarray(lab_pp))


def test_choose_s_tile_cost_model():
    """s_tile co-tuning: the cost model picks 128 at the flagship SC basis
    (where it dominates both cost terms) and a small tile for a tiny
    basis."""
    from sitator_tpu.ops.landmark_mxu import (choose_s_tile,
                                              prepare_engine_basis)
    n_c, a = 20, 4.0
    grid = np.stack(np.meshgrid(*[np.arange(n_c)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    cell = np.eye(3, dtype=np.float32) * (n_c * a)
    verts = np.zeros((len(grid), 8), np.int32)
    k = 0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                verts[:, k] = (((grid[:, 0] + di) % n_c) * n_c
                               + (grid[:, 1] + dj) % n_c) * n_c \
                    + (grid[:, 2] + dk) % n_c
                k += 1
    vmask = np.ones_like(verts, bool)
    site_pos = (grid + 0.5) * a
    assert choose_s_tile(verts, vmask, site_pos, cell) == 128
    # prepare_engine_basis default co-tunes
    basis = prepare_engine_basis(verts, vmask, site_pos, cell,
                                 midpoint=4.0, steepness=3.0,
                                 cutoff_shape="logistic")
    assert basis is not None and basis["s_tile"] == 128
    # candidates are powers of two (a block dimension of the Triton
    # kernel); a tiny basis stays at 128
    small = verts[:27] % 27
    assert choose_s_tile(small, np.ones_like(small, bool),
                         site_pos[:27], np.eye(3) * 12.0) == 128


def test_backend_gate_single_source():
    """Every lv-path choice in the package must go through
    ``kernel_common.lv_impl`` — one backend-neutral rule, so the engines'
    choices can never drift apart."""
    import pathlib
    import re
    pkg = pathlib.Path(__file__).resolve().parents[1] / "sitator_tpu"
    offenders = []
    for path in pkg.rglob("*.py"):
        if path.name == "kernel_common.py":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"default_backend\(\)\s*(==|!=|\bin\b)", line):
                offenders.append(f"{path.relative_to(pkg)}:{i}: {line.strip()}")
    assert not offenders, (
        "backend-name comparisons outside kernel_common.lv_impl:\n"
        + "\n".join(offenders))


def _sc_cell_system(n_c, triclinic, B=2, M=5, K=6, seed=43):
    """Simple-cubic cage basis in an orthorhombic or mildly skewed cell
    (positions built in fractional coordinates, so the cages stay
    compact in either)."""
    r = np.random.default_rng(seed)
    a = 4.0
    cell = np.eye(3) * n_c * a
    if triclinic:
        cell[1, 0] = 0.08 * n_c * a
        cell[2, 1] = 0.05 * n_c * a
    cell = cell.astype(np.float32)
    g = np.arange(n_c)
    grid = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)

    def idx(v):
        v = v % n_c
        return v[:, 0] * n_c * n_c + v[:, 1] * n_c + v[:, 2]

    verts = np.stack([idx(grid + d) for d in
                      np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                                           indexing="ij"), -1).reshape(-1, 3)
                      ], axis=1).astype(np.int32)
    vmask = np.ones_like(verts, dtype=bool)
    static0 = (grid / n_c) @ cell
    site_pos = ((grid + 0.5) / n_c) @ cell
    static = static0[None] + r.normal(scale=0.05, size=(B,) + static0.shape)
    home = r.choice(len(grid), M, replace=False)
    mobile = site_pos[home][None] + r.normal(scale=0.3, size=(B, M, 3))
    centers = r.random((K, len(grid))).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return (cell, mobile.astype(np.float32), static.astype(np.float32),
            verts, vmask, centers, site_pos, static0)


@pytest.mark.parametrize("preshift", [False, True])
@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("cutoff_shape", ["logistic", "logistic_r2"])
def test_triton_lv_kernel_interpret_matches_twin_and_dense(
        cutoff_shape, triclinic, preshift):
    """The Pallas-Triton lv kernel (interpret mode) against its plain-jnp
    twin and the dense XLA landmark vectors, over cutoff shape x cell
    shape x preshift route."""
    from sitator_tpu.ops.landmark_mxu import tiled_landmark_vectors
    from sitator_tpu.ops.pbc import kernel_cell
    mid, steep = 3.0, 12.0
    (cell, mobile, static, verts, vmask, centers, site_pos,
     static0) = _sc_cell_system(16, triclinic)
    kw = (dict(static_ref=static0, midpoint=mid, steepness=steep,
               cutoff_shape=cutoff_shape) if preshift else {})
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128,
                              **kw)
    assert basis["preshift"] == preshift
    zeros = (jnp.zeros((basis["n_st"], basis["UP"], 3), jnp.float32),
             jnp.zeros((basis["n_st"], 3), jnp.float32))
    ref_u, anchors = ((basis["ref_u"], basis["anchors"]) if preshift
                      else zeros)
    args = (jnp.asarray(mobile), jnp.asarray(static), basis["uidx"],
            basis["A"], basis["kill"], kernel_cell(cell), ref_u, anchors)
    lkw = dict(midpoint=mid, steepness=steep, cutoff_shape=cutoff_shape,
               preshift=preshift)
    lv_k = np.asarray(tiled_landmark_vectors(*args, impl="interpret",
                                             **lkw))
    lv_p = np.asarray(tiled_landmark_vectors(*args, impl="plain", **lkw))
    np.testing.assert_allclose(lv_k, lv_p, atol=1e-6)
    S = len(verts)
    assert not lv_k[..., S:].any()            # padded columns killed
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    dense = np.asarray(lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), mid, steep,
        cutoff_shape=cutoff_shape))
    np.testing.assert_allclose(lv_k[..., :S],
                               dense[..., basis["site_order"]], atol=2e-6)


@pytest.mark.parametrize("mxu_bf16", [False, True])
def test_xla_assign_peak_clip_matches_reference(mxu_bf16):
    """The XLA assign stage with peak_evening='clip' (plain twin) against
    the dense reference's peak_even + normalize + assign; bf16 operands
    keep every decision whose margin exceeds bf16 rounding."""
    r = np.random.default_rng(47)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(
        r, S=200, K=8)
    want_lab, want_conf = _xla_reference(cell, mobile, static, verts,
                                         vmask, centers, 0.3,
                                         peak_evening="clip")
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    got_lab, got_conf = mxu_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), basis,
        jnp.asarray(np.diag(cell).astype(np.float32)),
        permute_centers(centers, basis), midpoint=3.0, steepness=4.0,
        threshold=0.3, mxu_bf16=mxu_bf16, peak_evening="clip")
    tol = 1e-2 if mxu_bf16 else 2e-5
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=tol)
    sure = np.abs(np.asarray(want_conf) - 0.3) > tol
    np.testing.assert_array_equal(np.asarray(want_lab)[sure],
                                  np.asarray(got_lab)[sure])


@pytest.mark.parametrize("backend,interpret,want", [
    ("gpu", False, "triton"), ("cpu", False, "plain"),
    ("gpu", True, "interpret"), ("cpu", True, "interpret")])
def test_lv_impl_backend_rule(monkeypatch, backend, interpret, want):
    """One backend-neutral choice: the Triton kernel on a GPU, the plain
    twin elsewhere, the interpreter only when asked for."""
    import jax
    from sitator_tpu.ops.kernel_common import lv_impl
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert lv_impl(interpret) == want


def test_lv_kernel_failure_raises(monkeypatch):
    """A kernel that fails to lower raises — there is no quiet fallback to
    another route, at the op and at the engine level."""
    import sitator_tpu.ops.landmark_mxu as lmxu

    def broken(*a, **k):
        raise RuntimeError("kernel failed to lower")

    monkeypatch.setattr(lmxu, "_lv_pallas", broken)
    monkeypatch.setattr(lmxu, "lv_impl", lambda interpret=False: "triton")
    r = np.random.default_rng(53)
    cell, mobile, static, verts, vmask, centers, site_pos = _system(r)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128)
    with pytest.raises(RuntimeError, match="failed to lower"):
        mxu_assign_blocks(
            jnp.asarray(mobile) + 1e-3, jnp.asarray(static), basis,
            jnp.asarray(np.diag(cell).astype(np.float32)),
            permute_centers(centers, basis), midpoint=3.1, steepness=4.0,
            threshold=0.3)
    with pytest.raises(RuntimeError, match="failed to lower"):
        lmxu.mxu_landmark_blocks(
            jnp.asarray(mobile), jnp.asarray(static), basis,
            jnp.asarray(np.diag(cell).astype(np.float32)),
            midpoint=3.1, steepness=4.0)


@pytest.mark.gpu
def test_triton_lv_kernel_compiled_matches_twin():
    """On a GPU: the compiled Triton kernel (no interpreter) against its
    plain twin.  chip_smoke.py runs the same check at the flagship size."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "lowering (interpret-mode twin tests cover the math)")
    from sitator_tpu.ops.landmark_mxu import tiled_landmark_vectors
    from sitator_tpu.ops.pbc import kernel_cell
    (cell, mobile, static, verts, vmask, centers, site_pos,
     static0) = _sc_cell_system(16, False)
    basis = prepare_mxu_basis(verts, vmask, site_pos, cell, s_tile=128,
                              static_ref=static0, midpoint=3.0,
                              steepness=12.0, cutoff_shape="logistic_r2")
    args = (jnp.asarray(mobile), jnp.asarray(static), basis["uidx"],
            basis["A"], basis["kill"], kernel_cell(cell), basis["ref_u"],
            basis["anchors"])
    kw = dict(midpoint=3.0, steepness=12.0, cutoff_shape="logistic_r2",
              preshift=True)
    np.testing.assert_allclose(
        np.asarray(tiled_landmark_vectors(*args, impl="triton", **kw)),
        np.asarray(tiled_landmark_vectors(*args, impl="plain", **kw)),
        atol=1e-5)


@pytest.mark.parametrize("use_fused,sharing,want", [
    ("auto", True, "tiled:plain"), (True, False, "gather"),
    (False, True, "dense")])
def test_engine_path_choice(monkeypatch, use_fused, sharing, want):
    """One rule in every engine: the tiled path wherever the basis shares
    vertices (its plain twin on the CPU), the gather path otherwise, the
    dense reference only when asked for — recorded in ``kernel_path_``,
    with the same results."""
    import sitator_tpu.ops.landmark_mxu as lmxu
    from sitator_tpu import SiteNetwork
    from sitator_tpu.io.synthetic import make_hopping_trajectory
    from sitator_tpu.landmark import LandmarkAnalysis
    from sitator_tpu.voronoi import VoronoiSiteGenerator

    md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=40,
                                 jump_rate=0.02, seed=31)
    seeds = VoronoiSiteGenerator(merge_tol=0.05).run(
        SiteNetwork(md.structure, md.static_mask, md.mobile_mask))
    if not sharing:
        monkeypatch.setattr(lmxu, "prepare_engine_basis",
                            lambda *a, **k: None)
    kw = dict(cutoff_midpoint=4.0, cutoff_steepness=3.0,
              minimum_site_occupancy=0.01, verbose=False)
    la = LandmarkAnalysis(use_fused=use_fused, **kw)
    st = la.run(seeds, md.traj.astype(np.float32))
    assert la.kernel_path_ == want
    ref = LandmarkAnalysis(use_fused=False, **kw)
    st_ref = ref.run(seeds, md.traj.astype(np.float32))
    np.testing.assert_allclose(la.landmark_vectors, ref.landmark_vectors,
                               atol=5e-5)
    assert np.mean(st.traj == st_ref.traj) > 0.995
