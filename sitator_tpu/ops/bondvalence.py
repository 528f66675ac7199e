"""On-device bond-valence-sum maps over periodic grids.

Beyond the reference surface (upstream ``sitator`` seeds sites only via
Zeo++ Voronoi decomposition, SURVEY.md §3.3): the bond-valence-sum
(BVS) map is the standard *chemistry-driven* site-prediction route of
the solid-electrolyte literature (softBV-style): for a probe cation at
``r`` the bond valence against the counter-ion sublattice is

    V(r) = Σ_a exp((R0_a − |r − r_a|) / b)   over anions within cutoff,

and plausible cation sites are the basins where the mismatch
``|V(r) − V_ideal|`` is small (V_ideal = the cation's formal valence).
Unlike the Voronoi route (pure geometry) or the density route
(needs a trajectory), BVS needs only the static structure plus two
empirical constants per cation–anion pair.

Device mapping: the map is an all-pairs minimum-image distance block
(grid points × anions, ``pairwise_pbc_distances``) plus an
elementwise exp/sum — swept over grid chunks with static shapes, f32
with the distance math inherited from :mod:`sitator_tpu.ops.pbc`.

The default ``R0`` table below carries the classic Brese–O'Keeffe
(1991) bond-valence parameters for common mobile-cation/anion pairs
(b = 0.37 Å universal).  They are NOMINAL literature constants typed
from memory in an offline environment — verify (or pass explicit
``r0``) before production use on chemistry not covered by a test.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.ops import pbc

__all__ = ["bv_mismatch_grid", "bv_sums", "BV_R0", "BV_B"]

# (cation symbol, anion symbol) -> R0 [Å]; Brese–O'Keeffe-style values
BV_R0 = {
    ("Li", "O"): 1.466, ("Li", "S"): 1.94, ("Li", "F"): 1.36,
    ("Li", "Cl"): 1.91, ("Li", "Br"): 2.02, ("Li", "I"): 2.22,
    ("Na", "O"): 1.80, ("Na", "S"): 2.30, ("Na", "F"): 1.677,
    ("Na", "Cl"): 2.15,
    ("K", "O"): 2.13, ("K", "S"): 2.59, ("K", "F"): 1.992,
    ("Ag", "O"): 1.805, ("Ag", "S"): 2.119, ("Ag", "I"): 2.38,
    ("Mg", "O"): 1.693, ("Ca", "O"): 1.967, ("Zn", "O"): 1.704,
    ("Cu", "O"): 1.679, ("Al", "O"): 1.651, ("H", "O"): 0.95,
}
BV_B = 0.37          # Å, the near-universal bond-valence softness


@partial(jax.jit, static_argnames=())
def _bv_chunk(points, anions, r0, cell, cell_inv, b, cutoff):
    """Bond-valence sums of probe ``points (P, 3)`` against
    ``anions (A, 3)`` with per-anion ``r0 (A,)`` — ``(P,)`` f32."""
    d = pbc.pairwise_pbc_distances(points, anions, cell, cell_inv)
    v = jnp.exp((r0[None, :] - d) / b)
    return jnp.where(d < cutoff, v, 0.0).sum(axis=1)


def bv_sums(points, anions, r0, cell, b=BV_B, cutoff=6.0, chunk=65536):
    """Bond-valence sums for arbitrary probe ``points`` (host float64
    in/out; device-chunked compute)."""
    points = np.asarray(points, dtype=np.float64)
    anions = np.asarray(anions, dtype=np.float64)
    r0 = np.broadcast_to(np.asarray(r0, dtype=np.float64),
                         (len(anions),))
    cell = np.asarray(cell, dtype=np.float64)
    cell_j = jnp.asarray(cell.astype(np.float32))
    cell_inv = jnp.asarray(np.linalg.inv(cell).astype(np.float32))
    an_j = jnp.asarray(anions.astype(np.float32))
    r0_j = jnp.asarray(r0.astype(np.float32))
    out = np.empty(len(points), dtype=np.float64)
    for lo in range(0, len(points), chunk):
        part = jnp.asarray(points[lo:lo + chunk].astype(np.float32))
        out[lo:lo + chunk] = np.asarray(_bv_chunk(
            part, an_j, r0_j, cell_j, cell_inv,
            jnp.float32(b), jnp.float32(cutoff)))
    return out


def bv_mismatch_grid(anions, r0, cell, v_ideal, n_bins=48, b=BV_B,
                     cutoff=6.0, chunk=65536):
    """``|V(r) − v_ideal|`` on an ``(n_bins,)³`` periodic fractional
    grid (bin centers), host float64."""
    if n_bins < 2:
        raise ValueError("n_bins must be at least 2")
    if len(anions) == 0:
        raise ValueError("bv_mismatch_grid: no anions")
    ii = (np.arange(n_bins) + 0.5) / n_bins
    frac = np.stack(np.meshgrid(ii, ii, ii, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    points = frac @ np.asarray(cell, dtype=np.float64)
    sums = bv_sums(points, anions, r0, cell, b=b, cutoff=cutoff,
                   chunk=chunk)
    return np.abs(sums - float(v_ideal)).reshape(n_bins, n_bins, n_bins)
