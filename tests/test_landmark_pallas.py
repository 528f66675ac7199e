"""Per-vertex gather path (plain jnp) vs the dense XLA formulation, and the
cell helpers it shares with the tiled path."""
import numpy as np
import pytest

import jax.numpy as jnp

from sitator_tpu.ops import landmark as lmops
from sitator_tpu.ops.landmark_gather import gather_assign_blocks
from sitator_tpu.ops.pbc import kernel_cell, supports_cell


def _system(rng, B=2, M=7, N=40, S=20, V=5, K=6, L=11.0):
    cell_diag = np.array([L, L + 1, L + 2], np.float32)
    mobile = (rng.random((B, M, 3)) * L).astype(np.float32)
    static = (rng.random((B, N, 3)) * L).astype(np.float32)
    verts = np.stack([rng.choice(N, V, replace=False)
                      for _ in range(S)]).astype(np.int32)
    vmask = rng.random((S, V)) < 0.8
    vmask[:, 0] = True
    centers = rng.random((K, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    return cell_diag, mobile, static, verts, vmask, centers


def _xla_reference(cell_diag, mobile, static, verts, vmask, centers, thr):
    cell = np.diag(cell_diag).astype(np.float32)
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    lv = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0)
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    return lmops.assign_to_centers(lvn, jnp.asarray(centers),
                                   jnp.ones(len(centers), bool), thr)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_kernel_matches_xla(rng, seed):
    r = np.random.default_rng(seed)
    cell_diag, mobile, static, verts, vmask, centers = _system(r)
    want_lab, want_conf = _xla_reference(cell_diag, mobile, static, verts,
                                         vmask, centers, 0.35)
    got_lab, got_conf = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(cell_diag), jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.35, 
        mxu_bf16=False)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=1e-5)


def test_fused_kernel_site_padding_exact(rng):
    """S not a multiple of the tile: padded sites must not perturb results
    (they'd otherwise contribute lv=1 to every norm)."""
    r = np.random.default_rng(5)
    cell_diag, mobile, static, verts, vmask, centers = _system(
        r, S=33, K=4)
    want_lab, want_conf = _xla_reference(cell_diag, mobile, static, verts,
                                         vmask, centers, 0.2)
    got_lab, got_conf = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(cell_diag), jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.2, 
        mxu_bf16=False)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=1e-5)


def test_supports_cell():
    assert supports_cell(np.diag([3.0, 4.0, 5.0]))
    assert not supports_cell(np.array([[3, 0.1, 0], [0, 4, 0], [0, 0, 5.0]]))


def test_fused_kernel_full_mask_specialization(rng):
    """An all-valid vertex basis (every slot unmasked, as on the
    simple-cubic flagship) matches the dense XLA reference, frame by frame
    and across the frame-chunked block."""
    r = np.random.default_rng(7)
    cell_diag, mobile, static, verts, vmask, centers = _system(r)
    vmask = np.ones_like(vmask)
    want_lab, want_conf = _xla_reference(cell_diag, mobile, static, verts,
                                         vmask, centers, 0.35)
    got_lab, got_conf = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(cell_diag), jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.35, mxu_bf16=False)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=1e-5)


def test_fused_kernel_sharp_cutoff_no_nan(rng):
    """Extreme-but-legal steepness*midpoint > 87: one vertex's factor
    overflows (far) while another's underflows (ion on top of it) — the
    log-space sum must stay finite (no inf*0 = NaN), for either vertex
    mask."""
    L = 20.0
    cell_diag = np.array([L, L, L], np.float32)
    # site 0: vertex A at the ion's position (x -> -150), vertex B far
    static = np.array([[[1.0, 1.0, 1.0], [15.0, 15.0, 15.0]]], np.float32)
    mobile = np.array([[[1.0, 1.0, 1.0]]], np.float32)
    verts = np.array([[0, 1]], np.int32)
    centers = np.ones((1, 1), np.float32)
    for vmask in (np.ones((1, 2), bool), np.array([[False, True]])):
        lab, conf = gather_assign_blocks(
            jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
            jnp.asarray(vmask), jnp.asarray(cell_diag),
            jnp.asarray(centers), midpoint=3.0, steepness=50.0,
            threshold=0.1, mxu_bf16=False)
        assert np.isfinite(np.asarray(conf)).all(), vmask
        # the site's lv is ~0 (far vertex kills it): unassigned, conf 0
        assert np.asarray(lab)[0, 0] == -1


def test_kernel_cell_shapes():
    assert kernel_cell(np.diag([3.0, 4.0, 5.0])).shape == (3,)
    skew = np.array([[6, 0, 0], [1.2, 6, 0], [0.4, -0.8, 6.0]])
    assert kernel_cell(skew).shape == (3, 3)


@pytest.mark.parametrize("seed", [2, 3])
def test_fused_kernel_triclinic_matches_xla(rng, seed):
    """Skewed (triclinic) cell: the fractional round-trip must reproduce
    the XLA path (ops.pbc.min_image_disp) exactly."""
    r = np.random.default_rng(seed)
    L = 11.0
    cell = np.array([[L, 0, 0],
                     [0.25 * L, L + 1, 0],
                     [-0.15 * L, 0.2 * L, L + 2]], np.float32)
    B, M, N, S, V, K = 2, 7, 40, 20, 5, 6
    # positions spread over the (skewed) cell
    frac = r.random((B, M + N, 3)).astype(np.float32)
    pos = frac @ cell
    mobile, static = pos[:, :M], pos[:, M:]
    verts = np.stack([r.choice(N, V, replace=False)
                      for _ in range(S)]).astype(np.int32)
    vmask = r.random((S, V)) < 0.8
    vmask[:, 0] = True
    centers = r.random((K, S)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)

    A = lmops.vertex_membership_matrix(verts, vmask, N)
    lv = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0)
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    want_lab, want_conf = lmops.assign_to_centers(
        lvn, jnp.asarray(centers), jnp.ones(K, bool), 0.3)

    kc = kernel_cell(cell)
    assert kc.shape == (3, 3)
    got_lab, got_conf = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), kc, jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.3, 
        mxu_bf16=False)
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=2e-5)


@pytest.mark.parametrize("n_tiles_forced", [1, 2])
def test_fused_kernel_peak_clip_matches_xla(rng, n_tiles_forced):
    """peak_evening='clip' in the gather path must equal the XLA path's
    peak_even+normalize+assign, for small and large site counts."""
    r = np.random.default_rng(21 + n_tiles_forced)
    S = 20 if n_tiles_forced == 1 else 200
    cell_diag, mobile, static, verts, vmask, centers = _system(
        r, N=60, S=S, K=6)
    cell = np.diag(cell_diag).astype(np.float32)
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    lv = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0)
    lv = lmops.peak_even(lv, "clip")
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    want_lab, want_conf = lmops.assign_to_centers(
        lvn, jnp.asarray(centers), jnp.ones(len(centers), bool), 0.3)
    got_lab, got_conf = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(cell_diag), jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.3, 
        mxu_bf16=False, peak_evening="clip")
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=2e-5)


def test_fused_kernel_r2_cutoff_matches_xla(rng):
    r = np.random.default_rng(9)
    cell_diag, mobile, static, verts, vmask, centers = _system(r)
    cell = np.diag(cell_diag).astype(np.float32)
    A = lmops.vertex_membership_matrix(verts, vmask, static.shape[1])
    lv = lmops.landmark_vectors(
        jnp.asarray(mobile), jnp.asarray(static), A, jnp.asarray(cell),
        jnp.asarray(np.linalg.inv(cell), jnp.float32), 3.0, 4.0,
        cutoff_shape="logistic_r2")
    lvn, _ = lmops.normalize_landmark_vectors(lv)
    want_lab, want_conf = lmops.assign_to_centers(
        lvn, jnp.asarray(centers), jnp.ones(len(centers), bool), 0.3)
    got_lab, got_conf = gather_assign_blocks(
        jnp.asarray(mobile), jnp.asarray(static), jnp.asarray(verts),
        jnp.asarray(vmask), jnp.asarray(cell_diag), jnp.asarray(centers),
        midpoint=3.0, steepness=4.0, threshold=0.3, 
        mxu_bf16=False, cutoff_shape="logistic_r2")
    np.testing.assert_array_equal(np.asarray(want_lab), np.asarray(got_lab))
    np.testing.assert_allclose(np.asarray(want_conf), np.asarray(got_conf),
                               atol=1e-5)
