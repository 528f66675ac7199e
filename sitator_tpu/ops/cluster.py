"""On-device threshold-based cosine clustering (hot loop #2).

Device redesign of the reference ``sitator/util/DotProdClassifier.py``
(SURVEY.md §3.7): threshold-based agglomeration where the number of clusters
is *discovered*, not fixed.  The reference's online Python loop becomes:

- **seeding**: a bounded ``lax.while_loop`` that greedily adds the first
  still-uncovered sample as a new center, maintaining a running max-similarity
  per sample so each round costs one ``(n,) = X @ c`` matvec — O(n·D·K_max)
  total as matmuls instead of a Python loop;
- **refinement**: fixed-iteration Lloyd-style passes — assign by
  ``X @ Cᵀ`` argmax (threshold-gated), recompute centers by the one-hot
  matmul ``Wᵀ @ X``, renormalize;
- **capacity masking**: a static ``K_max`` with an ``active`` mask gives
  dynamic cluster counts with fully static shapes (SURVEY.md §8.3).

Samples are expected row-normalized (cosine == dot product).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sitator_tpu.ops.landmark import assign_to_centers

__all__ = ["dotprod_fit", "dotprod_refine", "ClusterResult"]


# cluster membership is decided by these f32 products; on a GPU they
# would otherwise run in TF32
_HIGHEST = jax.lax.Precision.HIGHEST

@partial(jax.jit, static_argnames=("k_max",))
def _seed(X, valid, k_max, cluster_threshold):
    n, d = X.shape

    def cond(carry):
        centers, k, max_sim = carry
        return (k < k_max) & jnp.any(max_sim < cluster_threshold)

    def body(carry):
        centers, k, max_sim = carry
        # first sample not yet covered by any center (deterministic order,
        # mirroring the reference's online pass)
        seed_idx = jnp.argmax(max_sim < cluster_threshold)
        c = X[seed_idx]
        centers = jax.lax.dynamic_update_index_in_dim(centers, c, k, axis=0)
        sims = jnp.matmul(X, c, precision=_HIGHEST)
        # progress guarantee: the seed itself is covered by fiat — a
        # sub-unit row's self-similarity is its norm², which can sit
        # below the threshold forever and would re-seed the same sample
        # until k_max otherwise
        sims = sims.at[seed_idx].set(jnp.inf)
        return centers, k + 1, jnp.maximum(max_sim, sims)

    centers0 = jnp.zeros((k_max, d), dtype=X.dtype)
    # invalid samples (e.g. all-zero landmark vectors) are treated as already
    # covered so they never seed a cluster
    max_sim0 = jnp.where(valid, -jnp.inf, jnp.inf).astype(X.dtype)
    centers, k, _ = jax.lax.while_loop(cond, body, (centers0, 0, max_sim0))
    return centers, k


@partial(jax.jit, static_argnames=("k_max", "n_iters"))
def dotprod_refine(X, centers, k, k_max, cluster_threshold, n_iters=10):
    """Lloyd-style refinement: threshold-gated argmax assignment, one-hot
    matmul recenter, renormalize.  Empty clusters keep their old center."""
    slot_active = jnp.arange(k_max) < k

    def step(carry, _):
        centers = carry
        sims = jnp.matmul(X, centers.T, precision=_HIGHEST)  # (n, K)
        sims = jnp.where(slot_active[None, :], sims, -jnp.inf)
        conf = jnp.max(sims, axis=1)
        label = jnp.argmax(sims, axis=1)
        w = jax.nn.one_hot(label, k_max, dtype=X.dtype)
        w = w * (conf >= cluster_threshold)[:, None]
        counts = jnp.sum(w, axis=0)                       # (K,)
        newc = jnp.matmul(w.T, X, precision=_HIGHEST)       # (K, D)
        norms = jnp.sqrt(jnp.sum(newc * newc, axis=1, keepdims=True))
        newc = newc / jnp.maximum(norms, 1e-12)
        centers = jnp.where((counts > 0)[:, None], newc, centers)
        return centers, counts

    centers, counts = jax.lax.scan(step, centers, None, length=n_iters)
    return centers, counts[-1]


class ClusterResult(dict):
    """centers (K_max, D), active (K_max,), counts (K_max,), n_clusters."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def dotprod_fit(X, k_max, cluster_threshold, min_samples=1, n_iters=10,
                valid=None):
    """Fit threshold-based cosine clusters on row-normalized ``X (n, D)``.

    ``valid`` masks samples eligible to seed clusters.  Regardless of
    ``valid``, samples whose row norm is below ``cluster_threshold``
    never seed: ``sim(x, c) ≤ |x|`` for unit centers, so such a sample
    can never be covered by ANY center — seeding it would spin the
    greedy pass on an uncoverable point (they simply end unassigned at
    prediction).  Rows are expected ~unit-normalized; sub-unit rows are
    tolerated but treated as above.
    """
    coverable = jnp.sum(X * X, axis=1) >= cluster_threshold ** 2
    valid = coverable if valid is None else (valid & coverable)
    centers, k = _seed(X, valid, k_max, cluster_threshold)
    centers, counts = dotprod_refine(X, centers, k, k_max, cluster_threshold,
                                     n_iters=n_iters)
    active = (jnp.arange(k_max) < k) & (counts >= min_samples)
    return ClusterResult(centers=centers, active=active, counts=counts,
                         n_clusters=int(jnp.sum(active)))
