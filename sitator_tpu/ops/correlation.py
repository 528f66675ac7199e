"""On-device pair-correlation histograms: RDF and van Hove functions.

Beyond the reference surface (upstream ``sitator`` stops at jump
statistics, SURVEY.md §3.4) — the standard structural/kinetic
correlation functions of the superionic-conductor literature:

- :func:`rdf`: the radial distribution function g(r) between two atom
  selections, frame-averaged.
- :func:`van_hove_distinct`: G_d(r, t) — the probability (relative to
  ideal gas) of finding a *different* ion at distance r after lag t;
  its t→∞ limit is g(r), and filling of the r→0 hole is the classic
  signature of correlated site exchange.
- :func:`van_hove_self` (host): P(r, t) = 4πr²G_s — the distribution of
  single-ion displacement magnitudes after lag t; hop-length peaks make
  discrete jump diffusion visible.

Device mapping: each (origin-frame, lag) pair needs an all-pairs
minimum-image distance block — O(N²) work that rides
:func:`~sitator_tpu.ops.pbc.pairwise_pbc_distances` (statically
shaped) — followed by a fixed-bin histogram
(``searchsorted`` + ``segment_sum``).  Frames are swept with
``lax.scan`` in bounded chunks: the device carry is int32 (exact — a
float32 carry silently drops increments past 2^24) with chunk sizes
capped so a chunk cannot overflow, and the host accumulates chunk
results in int64.  All lags of :func:`van_hove_distinct` share one
origin grid (and therefore one compiled program).  The self part is a cheap O(N·F) host pass in float64
over the unwrapped trajectory (same precision reasoning as
:mod:`sitator_tpu.ops.msd`).

Minimum-image validity: ``r_max`` may not exceed half the shortest cell
height (the single-round-trip guarantee); with ``exact=True`` the
27-image exact minimum distance extends validity to the full height at
~27× the distance cost.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.ops import pbc
from sitator_tpu.ops.msd import unwrap_trajectory

__all__ = ["rdf", "van_hove_distinct", "van_hove_self"]

# a single scan chunk must satisfy chunk * Na * Nb < 2^31 (int32 carry)
_MAX_CHUNK_PAIRS = 2 ** 31 - 2 ** 24
_DEFAULT_CHUNK = 512


def _bin_counts(dists, valid, r_max, n_bins):
    """Histogram ``dists`` where ``valid`` into n_bins over [0, r_max),
    as exact int32 counts."""
    idx = jnp.floor(dists * (n_bins / r_max)).astype(jnp.int32)
    ok = valid & (idx >= 0) & (idx < n_bins)
    idx = jnp.where(ok, idx, n_bins)                  # overflow bucket
    counts = jax.ops.segment_sum(
        jnp.where(ok, 1, 0).ravel().astype(jnp.int32), idx.ravel(),
        num_segments=n_bins + 1)
    return counts[:n_bins]


@partial(jax.jit, static_argnames=("n_bins", "exact"))
def _pair_hist_chunk(frames_a, frames_b, exclude, cell, r_max, n_bins,
                     exact):
    """Sum of pair-distance histograms over paired frame stacks
    ``(C, Na, 3) × (C, Nb, 3)`` → int32 ``(n_bins,)``.  ``exclude`` is a
    ``(Na, Nb)`` bool matrix of pairs to drop (same-atom pairs across
    overlapping selections)."""
    cell = jnp.asarray(cell, dtype=frames_a.dtype)
    cell_inv = pbc.cell_inverse(cell)

    def step(acc, ab):
        a, b = ab
        d = pbc.pairwise_pbc_distances(a, b, cell, cell_inv, exact=exact)
        return acc + _bin_counts(d, ~exclude, r_max, n_bins), None

    init = jnp.zeros((n_bins,), dtype=jnp.int32)
    out, _ = jax.lax.scan(step, init, (frames_a, frames_b))
    return out


def _pair_hist(frames_a, frames_b, exclude, cell, r_max, n_bins, exact):
    """Host driver: chunk the frame axis (int32-exact device carries,
    int64 host accumulation) → int64 ``(n_bins,)``.  At most two
    compiled shapes per (Na, Nb): the full chunk and one ragged tail."""
    F, na = frames_a.shape[:2]
    nb = frames_b.shape[1]
    chunk = min(F, _DEFAULT_CHUNK,
                max(1, _MAX_CHUNK_PAIRS // max(1, na * nb)))
    exclude = jnp.asarray(exclude)
    fa = jnp.asarray(frames_a)
    fb = jnp.asarray(frames_b)
    total = np.zeros(n_bins, dtype=np.int64)
    for s in range(0, F - F % chunk, chunk):
        total += np.asarray(
            _pair_hist_chunk(fa[s:s + chunk], fb[s:s + chunk], exclude,
                             cell, float(r_max), int(n_bins), bool(exact)),
            dtype=np.int64)
    tail = F % chunk
    if tail:
        total += np.asarray(
            _pair_hist_chunk(fa[F - tail:], fb[F - tail:], exclude,
                             cell, float(r_max), int(n_bins), bool(exact)),
            dtype=np.int64)
    return total


def _shell_volumes(r_max, n_bins):
    edges = np.linspace(0.0, r_max, n_bins + 1)
    return 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3), edges


def _resolve_r_max(r_max, cell, exact):
    """Default and validate ``r_max`` against the minimum-image validity
    radius (half the shortest cell height; the full height with the
    27-image exact mode)."""
    height = float(_min_cell_height(cell))
    limit = height if exact else 0.5 * height
    if r_max is None:
        return 0.5 * height
    r_max = float(r_max)
    if r_max > limit * (1 + 1e-9):
        raise ValueError(
            f"r_max={r_max:g} exceeds the minimum-image validity radius "
            f"{limit:g} for this cell (shortest height {height:g}); "
            + ("shrink r_max"
               if exact else "shrink r_max or pass exact=True"))
    return r_max


def _exclude_matrix(mask_a, mask_b):
    """(Na, Nb) bool matrix marking pairs that are the SAME original
    atom under the two selections (handles identical, subset,
    overlapping and disjoint selections alike)."""
    ia = np.where(mask_a)[0]
    ib = np.where(mask_b)[0]
    return ia[:, None] == ib[None, :]


def rdf(traj, cell, mask_a, mask_b=None, r_max=None, n_bins=200,
        exact=False):
    """Frame-averaged radial distribution function g(r).

    traj ``(F, N, 3)`` wrapped or not (minimum-image throughout);
    ``mask_a``/``mask_b`` boolean atom selections (b defaults to a; any
    atom present in both selections is never paired with itself, and
    the normalization accounts for the overlap).  Returns
    ``(r_centers, g)`` as float64 NumPy arrays.  ``r_max`` defaults to
    half the shortest cell height and is validated against the
    minimum-image limit (``exact=True`` enables the 27-image exact
    distance, extending validity to the full height).
    """
    traj = np.asarray(traj)
    cell = np.asarray(cell, dtype=np.float64)
    mask_a = np.asarray(mask_a, dtype=bool)
    mask_b = mask_a if mask_b is None else np.asarray(mask_b, dtype=bool)
    r_max = _resolve_r_max(r_max, cell, exact)
    exclude = _exclude_matrix(mask_a, mask_b)
    counts = _pair_hist(traj[:, mask_a, :], traj[:, mask_b, :], exclude,
                        cell, r_max, int(n_bins), exact).astype(np.float64)
    shells, edges = _shell_volumes(float(r_max), int(n_bins))
    vol = float(abs(np.linalg.det(cell)))
    n_pairs = int(mask_a.sum()) * int(mask_b.sum()) - int(exclude.sum())
    norm = traj.shape[0] * n_pairs * shells / vol
    g = np.divide(counts, norm, out=np.zeros_like(counts),
                  where=norm > 0)
    return 0.5 * (edges[1:] + edges[:-1]), g


def van_hove_distinct(traj, cell, mask, lags, r_max=None, n_bins=200,
                      origin_stride=1, exact=False):
    """Distinct van Hove function G_d(r, t) for the selected ions.

    For each lag t in ``lags`` (frames), histogram the minimum-image
    distances between ion i at an origin frame and every *other* ion j
    at origin+t, averaged over origins, normalized like g(r) (ideal gas
    → 1).  All lags share one origin grid —
    ``range(0, F - max(lags), origin_stride)`` — so every lag reuses
    the same compiled device program and the same statistics base.
    Returns ``(r_centers, G)`` with ``G.shape == (len(lags), n_bins)``.
    """
    traj = np.asarray(traj)
    cell = np.asarray(cell, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    r_max = _resolve_r_max(r_max, cell, exact)
    F = traj.shape[0]
    lags = [int(l) for l in lags]
    for lag in lags:
        if not 0 <= lag < F:
            raise ValueError(f"lag {lag} outside 0..{F - 1}")
    ions = traj[:, mask, :]
    n = int(mask.sum())
    # non-empty by construction: lag < F ⇒ the range contains origin 0
    origins = np.arange(0, F - max(lags), int(origin_stride))
    shells, edges = _shell_volumes(float(r_max), int(n_bins))
    vol = float(abs(np.linalg.det(cell)))
    eye = np.eye(n, dtype=bool)
    out = np.empty((len(lags), n_bins), dtype=np.float64)
    for k, lag in enumerate(lags):
        counts = _pair_hist(ions[origins], ions[origins + lag], eye,
                            cell, r_max, int(n_bins),
                            exact).astype(np.float64)
        norm = len(origins) * n * (n - 1) * shells / vol
        out[k] = np.divide(counts, norm, out=np.zeros_like(counts),
                           where=norm > 0)
    return 0.5 * (edges[1:] + edges[:-1]), out


def van_hove_self(traj, cell, mask, lags, r_max=None, n_bins=200,
                  origin_stride=1, exact=False):
    """Self part as the displacement-magnitude density P(r, t) = 4πr²G_s:
    for each lag, the probability density (per unit r, integrates to 1 up
    to ``r_max``) of an ion having moved distance r.  Host float64 over
    the unwrapped trajectory; ``r_max`` here is a histogram window, not
    a minimum-image limit (displacements are unwrapped), and defaults to
    half the shortest cell height for comparability with the distinct
    part.  Returns ``(r_centers, P)`` with
    ``P.shape == (len(lags), n_bins)``.
    """
    traj = np.asarray(traj)
    cell = np.asarray(cell, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool)
    un = unwrap_trajectory(traj[:, mask, :], cell, exact=exact)
    F = un.shape[0]
    if r_max is None:
        r_max = 0.5 * float(_min_cell_height(cell))
    edges = np.linspace(0.0, float(r_max), int(n_bins) + 1)
    dr = edges[1] - edges[0]
    out = np.empty((len(lags), int(n_bins)), dtype=np.float64)
    for k, lag in enumerate(lags):
        lag = int(lag)
        if not 0 <= lag < F:
            raise ValueError(f"lag {lag} outside 0..{F - 1}")
        origins = np.arange(0, F - lag, int(origin_stride))
        disp = un[origins + lag] - un[origins]
        r = np.sqrt((disp ** 2).sum(-1)).ravel()
        counts, _ = np.histogram(r, bins=edges)
        out[k] = counts / (len(r) * dr)
    return 0.5 * (edges[1:] + edges[:-1]), out


def _min_cell_height(cell):
    """Shortest perpendicular height of the (possibly triclinic) cell —
    the minimum-image validity radius is half of it."""
    inv = np.linalg.inv(np.asarray(cell, dtype=np.float64))
    # column i of inv is the reciprocal vector of face i; the height is
    # 1/|that column|
    return (1.0 / np.linalg.norm(inv, axis=0)).min()
