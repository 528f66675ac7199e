"""On-device occupancy density grids + host peak extraction.

Beyond the reference surface (upstream ``sitator`` seeds sites only via
Zeo++ Voronoi decomposition, SURVEY.md §3.3): time-averaged mobile-ion
density is the other standard site-detection route in the
superionic-conductor literature — sites are where the ions actually
*are*, not where the empty-lattice geometry says they could be.  The
two seeding paths are complementary: Voronoi works from the static
lattice alone (no trajectory needed), density needs a trajectory but
finds exactly the occupied basins (including interstitial sites a
geometric decomposition misses, and none of the never-visited nodes).

Device mapping: the grid accumulation is the hot part (O(F·M)) and runs
on device — fractional coordinates, ``floor`` to bin triplets, one
``segment_sum`` scatter-add per frame chunk, exact int32 counts with
chunk sizes capped so a chunk cannot overflow, host-accumulated in
int64 (same exactness discipline as :mod:`sitator_tpu.ops.correlation`).
Smoothing/peak finding run once on the host in float64: a periodic
Gaussian filter in fractional space (per-axis widths from the cell
heights, so ``sigma`` is in length units even for triclinic cells),
26-neighbor local maxima, sub-bin refinement by a periodic
center-of-mass over the 3³ neighborhood, and greedy minimum-image
non-maximum suppression.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["density_grid", "smooth_density", "find_density_peaks"]

# one chunk's scatter-add must stay within exact-int32 territory
_MAX_CHUNK_POINTS = 2 ** 31 - 2 ** 24


@partial(jax.jit, static_argnames=("n_bins",))
def _grid_chunk(pos, cell_inv, n_bins):
    """Bin a ``(C, M, 3)`` cartesian chunk into a flat ``(n_bins³,)``
    int32 periodic histogram."""
    # precision pin: an accelerator's default f32 matmul may run with
    # reduced-precision operands (TF32 on a GPU, ~1e-3 relative) — enough
    # to move seam-adjacent atoms a whole bin and break the exact-count
    # contract (see ops/scattering.py's identical pin)
    frac = jnp.matmul(pos.reshape(-1, 3), cell_inv,
                      precision=jax.lax.Precision.HIGHEST)
    frac = frac - jnp.floor(frac)                     # wrap into [0, 1)
    idx = jnp.clip((frac * n_bins).astype(jnp.int32), 0, n_bins - 1)
    flat = (idx[:, 0] * n_bins + idx[:, 1]) * n_bins + idx[:, 2]
    return jax.ops.segment_sum(
        jnp.ones(flat.shape[0], jnp.int32), flat,
        num_segments=n_bins ** 3)


def density_grid(traj, cell, mask=None, n_bins=48, chunk=2048, stride=1):
    """Periodic occupancy histogram of the selected atoms over the whole
    trajectory: ``(n_bins, n_bins, n_bins)`` int64 counts in fractional
    space (bin ``[i,j,k]`` covers fractional ``[i/n, (i+1)/n)`` etc.).
    ``stride`` counts every ``stride``-th frame only — an unbiased
    whole-run subsample for seeding from long trajectories (reads stay
    chunked; skipped frames in a chunk are fetched but not binned).

    ``traj`` is ``(F, N, 3)`` cartesian (wrapped or not — coordinates
    are wrapped into the cell here): an in-memory array OR any sliceable
    trajectory reader (``len()`` + ``reader[lo:hi] -> (C, N, 3)``, e.g.
    ``NpyTrajectory`` / ``TensorstoreTrajectory``) — readers are swept
    chunkwise without ever materializing the trajectory.  ``mask``
    selects the atoms to count (default: all).  Device scatter-add in
    exact int32 chunks, host accumulation in int64.
    """
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
    F = len(traj)
    probe = np.asarray(traj[0:1])
    M = int(mask.sum()) if mask is not None else probe.shape[1]
    if M == 0:
        raise ValueError("density_grid: no atoms selected")
    if n_bins < 2:
        raise ValueError("n_bins must be at least 2")
    stride = int(stride)
    if stride < 1:
        raise ValueError("stride must be at least 1")
    cell_inv = jnp.asarray(
        np.linalg.inv(np.asarray(cell, dtype=np.float64)).astype(
            np.float32))
    chunk = max(1, min(int(chunk), _MAX_CHUNK_POINTS // M))
    # chunk boundaries on stride multiples keep the global subsample
    # (frames 0, stride, 2·stride, ...) aligned across chunks
    chunk = max(stride, (chunk // stride) * stride)
    grid = np.zeros(n_bins ** 3, dtype=np.int64)
    counted = 0
    for lo in range(0, F, chunk):
        part = np.asarray(traj[lo:lo + chunk])[::stride]
        if mask is not None:
            part = part[:, mask, :]
        counted += part.shape[0]
        part = jnp.asarray(part.astype(np.float32))
        grid += np.asarray(_grid_chunk(part, cell_inv, n_bins),
                           dtype=np.int64)
    assert counted == len(range(0, F, stride))
    assert grid.sum() == counted * M                 # nothing dropped
    return grid.reshape(n_bins, n_bins, n_bins)


def _cell_heights(cell):
    """Perpendicular distance between opposite faces, per axis."""
    cell = np.asarray(cell, dtype=np.float64)
    vol = abs(np.linalg.det(cell))
    return np.array([vol / np.linalg.norm(
        np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3]))
        for i in range(3)])


def smooth_density(grid, cell, sigma):
    """Periodic Gaussian smoothing of a fractional-space grid with an
    isotropic real-space width ``sigma`` (length units): per-axis bin
    widths come from the cell heights, so skewed cells smooth
    isotropically in cartesian space (to first order)."""
    from scipy.ndimage import gaussian_filter
    grid = np.asarray(grid, dtype=np.float64)
    heights = _cell_heights(cell)
    sig_bins = [float(sigma) / (h / n)
                for h, n in zip(heights, grid.shape)]
    return gaussian_filter(grid, sigma=sig_bins, mode="wrap")


def find_density_peaks(smoothed, cell, threshold_rel=0.05,
                       min_distance=1.0):
    """Local maxima of a periodic density grid → cartesian centers.

    A bin is a peak when it is ≥ all 26 periodic neighbors and above
    ``threshold_rel × max``.  Each peak is refined to sub-bin accuracy
    by the center of mass of its (background-subtracted) 3³
    neighborhood, then peaks closer than ``min_distance`` (minimum
    image) are merged greedily, strongest first.

    Returns ``(centers, weights)``: ``(P, 3)`` cartesian positions and
    the smoothed density at each surviving peak, strongest first.
    """
    from sitator_tpu.network.compare import min_image_distance_matrix
    g = np.asarray(smoothed, dtype=np.float64)
    n = g.shape
    is_max = np.ones(n, dtype=bool)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                if di == dj == dk == 0:
                    continue
                is_max &= g >= np.roll(g, (di, dj, dk), axis=(0, 1, 2))
    thr = threshold_rel * g.max()
    peaks = np.argwhere(is_max & (g > thr))
    if len(peaks) == 0:
        return np.zeros((0, 3)), np.zeros(0)
    vals = g[tuple(peaks.T)]
    order = np.argsort(vals)[::-1]
    peaks, vals = peaks[order], vals[order]

    # sub-bin refinement: periodic CoM of the 3^3 neighborhood, with
    # the neighborhood's own floor subtracted so the flat background
    # does not drag the estimate toward the bin center
    offs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], dtype=np.float64)
    nbr_idx = (peaks[:, None, :] + offs[None].astype(np.int64))
    nbr_idx = nbr_idx % np.array(n)
    w = g[nbr_idx[..., 0], nbr_idx[..., 1], nbr_idx[..., 2]]
    w = w - w.min(axis=1, keepdims=True)
    denom = np.maximum(w.sum(axis=1, keepdims=True), 1e-300)
    shift = (w[..., None] * offs[None]).sum(axis=1) / denom
    frac = (peaks + 0.5 + shift) / np.array(n)
    cart = frac @ np.asarray(cell, dtype=np.float64)

    # greedy minimum-image non-maximum suppression, strongest first
    D = min_image_distance_matrix(cart, cart, cell)
    keep = []
    for i in range(len(cart)):
        if all(D[i, j] >= min_distance for j in keep):
            keep.append(i)
    return cart[keep], vals[keep]
