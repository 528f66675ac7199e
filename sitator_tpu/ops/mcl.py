"""Markov Clustering (MCL) as on-device matrix iteration.

Reference parity: ``sitator/util/mcl.py`` (SURVEY.md §3.7), used by
``MergeSitesByDynamics``.  The expansion step is a dense ``(S, S)`` matmul and inflation/pruning are fused elementwise ops; the whole
convergence loop is a bounded ``lax.while_loop`` on device.  Cluster
extraction from the converged (idempotent) matrix is a tiny host-side pass.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["mcl_iterate", "markov_cluster"]


def _normalize_cols(m):
    s = jnp.sum(m, axis=0, keepdims=True)
    return m / jnp.maximum(s, 1e-30)


@partial(jax.jit, static_argnames=("expansion", "max_iters"))
def mcl_iterate(T, inflation, expansion=2, max_iters=100, prune=1e-6,
                tol=1e-8):
    """Iterate MCL (expand → inflate → prune → renormalize) to convergence.

    ``T`` is a column-stochastic (S, S) matrix.  Returns the converged
    matrix."""

    def cond(carry):
        m, prev, i = carry
        delta = jnp.max(jnp.abs(m - prev))
        return (i < max_iters) & (delta > tol)

    def body(carry):
        m, _, i = carry
        prev = m
        # expansion = matrix power m**expansion (NOT repeated squaring,
        # which would give m**(2**(expansion-1)) for expansion > 2)
        for _ in range(expansion - 1):
            m = jnp.dot(m, prev, preferred_element_type=jnp.float32)
        m = jnp.power(jnp.maximum(m, 0.0), inflation)
        m = jnp.where(m < prune, 0.0, m)
        m = _normalize_cols(m)
        return m, prev, i + 1

    T = _normalize_cols(T)
    out, _, _ = jax.lax.while_loop(
        cond, body, (T, jnp.full_like(T, jnp.inf), 0))
    return out


def markov_cluster(T, inflation=2.0, expansion=2, max_iters=100,
                   prune=1e-6):
    """Run MCL and extract clusters.

    Returns a list of int arrays — the node groups (covering all S nodes;
    singleton groups included).  Nodes attracted to multiple attractors join
    their first (lowest-index) attractor, making the output a partition.
    """
    T = jnp.asarray(T, dtype=jnp.float32)
    m = np.asarray(mcl_iterate(T, float(inflation), expansion=expansion,
                               max_iters=max_iters, prune=prune))
    S = m.shape[0]
    # attractors: rows with significant mass (classic MCL extraction)
    attractors = np.flatnonzero(m.max(axis=1) > 1e-4)
    assigned = np.full(S, -1, dtype=np.int64)
    groups = []
    for a in attractors:
        members = np.flatnonzero(m[a] > 1e-4)
        members = members[assigned[members] < 0]
        if len(members) == 0:
            continue
        assigned[members] = len(groups)
        groups.append(members)
    # orphans (numerically lost mass) become singletons
    for i in np.flatnonzero(assigned < 0):
        assigned[i] = len(groups)
        groups.append(np.array([i]))
    return groups
