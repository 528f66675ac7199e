"""Landmark-vector computation as fused XLA array ops (hot loop #1).

Dense plain-XLA form of the reference Cython kernel
``sitator/landmark/helpers.pyx :: _fill_landmark_vectors`` (SURVEY.md §3.2) —
the plain reference the tiled and gather paths are tested against, and the
explicit ``use_fused=False`` route.  The reference loops
``frame → ion → site → vertex`` computing
``Π_v cutoff(min_image_dist(ion, vertex_v))`` one scalar at a time.  Here the
same math is reshaped for a matrix unit:

1. per-pair log-cutoff matrix ``logC[b, m, n] = log σ(-k (d(m,n) - d0))``
   over (frame, mobile, static) — dense elementwise work, where ``d`` is
   the minimum-image distance;
2. the product over each site's vertex atoms becomes a **matmul** with the
   0/1 vertex-membership matrix ``A[n, s]``:
   ``log lvec[b, m, s] = logC[b, m, :] @ A[:, s]`` — one
   ``(B·M, N) @ (N, S)`` contraction;
3. ``lvec = exp(...)`` — computing the product in log space also fixes the
   fp32/bf16 underflow of long products of logistics (SURVEY.md §8.3).

Multiplicity is supported: if an atom appears twice in a site's vertex list,
``A[n, s] = 2`` reproduces the squared factor exactly.

Everything is jit/vmap/shard_map-safe with static shapes; the frame axis is
the sharding axis (SURVEY.md §3.10).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.ops.pbc import min_image_disp

_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = [
    "vertex_membership_matrix",
    "log_cutoff",
    "log_cutoff_r2",
    "landmark_vectors",
    "normalize_landmark_vectors",
    "peak_even",
    "assign_to_centers",
    "max_static_drift",
]


def vertex_membership_matrix(verts, vmask, n_static, dtype=jnp.float32):
    """Build the (n_static, n_sites) membership matrix A from padded vertex
    indices ``verts (S, V)`` + validity ``vmask (S, V)``.

    ``A[n, s]`` = number of times static atom ``n`` appears among site ``s``'s
    vertices (0/1 for simple polyhedra; >1 reproduces repeated factors).
    Host-side, run once per analysis.
    """
    verts = np.asarray(verts)
    vmask = np.asarray(vmask)
    S, V = verts.shape
    A = np.zeros((n_static, S), dtype=np.float32)
    sites = np.broadcast_to(np.arange(S)[:, None], (S, V))
    np.add.at(A, (verts[vmask], sites[vmask]), 1.0)
    return jnp.asarray(A, dtype=dtype)


def log_cutoff(d, midpoint, steepness):
    """log of the logistic switching function
    ``c(d) = 1 / (1 + exp(steepness (d - midpoint)))`` — numerically stable as
    ``-softplus(steepness (d - midpoint))`` (paper Eq. for the landmark
    cutoff; reference ``helpers.pyx`` computes ``c`` directly)."""
    return -jax.nn.softplus(steepness * (d - midpoint))


def log_cutoff_r2(d2, midpoint, steepness):
    """Fast cutoff variant: logistic in d² —
    ``c(d) = 1/(1+exp(k' (d² - d0²)))`` with ``k' = steepness/(2 d0)`` so
    value (½) and slope at the midpoint match :func:`log_cutoff`.  Same
    smooth-switch physics, no sqrt on the hot path; select with
    ``cutoff_shape='logistic_r2'``."""
    k2 = steepness / (2.0 * midpoint)
    return -jax.nn.softplus(k2 * (d2 - midpoint * midpoint))


def landmark_vectors(mobile, static, A, cell, cell_inv, midpoint, steepness,
                     matmul_dtype=None, cutoff_shape="logistic"):
    """Landmark vectors for a block of frames.

    Parameters
    ----------
    mobile : (B, M, 3) mobile-ion positions.
    static : (B, N, 3) static-lattice positions (instantaneous, per frame).
    A : (N, S) vertex-membership matrix.
    cell, cell_inv : (3, 3).
    midpoint, steepness : logistic cutoff parameters.
    matmul_dtype : optional dtype (e.g. ``jnp.bfloat16``) for the log-space
        contraction operands — positions/distances stay fp32; only the
        matmul runs reduced.  Cosine-threshold decisions tolerate the <1%
        perturbation; parity tests use the default fp32.

    Returns
    -------
    (B, M, S) float32 landmark vectors in [0, 1].
    """
    diff = mobile[:, :, None, :] - static[:, None, :, :]      # (B, M, N, 3)
    diff = min_image_disp(diff, cell, cell_inv)
    d2 = jnp.sum(diff * diff, axis=-1)                        # (B, M, N)
    if cutoff_shape == "logistic":
        logc = log_cutoff(jnp.sqrt(d2), midpoint, steepness)
    elif cutoff_shape == "logistic_r2":
        logc = log_cutoff_r2(d2, midpoint, steepness)
    else:
        raise ValueError(f"unknown cutoff_shape {cutoff_shape!r}")
    if matmul_dtype is not None:
        logc = logc.astype(matmul_dtype)
        A = A.astype(matmul_dtype)
    # product over vertices == matmul in log space; an f32 contraction is
    # meant as f32 (a GPU would otherwise run it in TF32)
    loglv = jax.lax.dot_general(
        logc, A,
        dimension_numbers=(((2,), (0,)), ((), ())),
        precision=_HIGHEST if matmul_dtype is None else None,
        preferred_element_type=jnp.float32,
    )                                                          # (B, M, S)
    return jnp.exp(loglv)


def normalize_landmark_vectors(lv, eps=1e-12):
    """Row-normalize to unit L2 norm; all-zero rows stay zero.

    Returns (normalized, norms)."""
    norms = jnp.sqrt(jnp.sum(lv * lv, axis=-1, keepdims=True))
    return lv / jnp.maximum(norms, eps), norms[..., 0]


def peak_even(lv, mode: str):
    """Peak evening (reference ``peak_evening`` ctor param, SURVEY.md §3.2 ⚠):
    flatten over-tall peaks before clustering so similarity reflects the
    *pattern* of landmarks touched, not one dominant peak.

    'none' — identity.  'clip' — cap every component at the vector's
    second-largest value (evens the single tallest peak).
    """
    if mode == "none":
        return lv
    if mode == "clip":
        top2 = jax.lax.top_k(lv, 2)[0]          # (..., 2)
        cap = top2[..., 1:2]
        return jnp.minimum(lv, cap)
    raise ValueError(f"unknown peak_evening mode {mode!r}")


def assign_to_centers(lv_norm, centers, active, assignment_threshold,
                      matmul_dtype=None):
    """Assign normalized landmark vectors to the best cluster center.

    lv_norm : (..., S) unit vectors; centers : (K, S) unit rows;
    active : (K,) bool.  Returns (labels (...,), confidences (...,)) with
    label -1 (SITE_UNKNOWN) where the best dot product is below threshold.
    """
    if matmul_dtype is not None:
        lv_norm = lv_norm.astype(matmul_dtype)
        centers = centers.astype(matmul_dtype)
    sims = jax.lax.dot_general(
        lv_norm, centers,
        dimension_numbers=(((lv_norm.ndim - 1,), (1,)), ((), ())),
        precision=_HIGHEST if matmul_dtype is None else None,
        preferred_element_type=jnp.float32,
    )                                                          # (..., K)
    sims = jnp.where(active, sims, -jnp.inf)
    labels = jnp.argmax(sims, axis=-1).astype(jnp.int32)
    confs = jnp.max(sims, axis=-1)
    labels = jnp.where(confs >= assignment_threshold, labels, -1)
    return labels, confs


def max_static_drift(static_block, static_ref, cell, cell_inv):
    """Max minimum-image displacement of any static atom in the block from
    its reference position — feeds ``StaticLatticeError`` detection."""
    diff = min_image_disp(static_block - static_ref[None], cell, cell_inv)
    return jnp.sqrt(jnp.max(jnp.sum(diff * diff, axis=-1)))


def static_drift_per_frame(static_block, static_ref, cell, cell_inv):
    """Per-frame max minimum-image drift of the static lattice: (B,).

    Feeds ``dynamic_lattice_mapping``: the first frame whose drift exceeds
    the threshold marks a candidate lattice-site exchange, localized on
    host before the slot→atom permutation is rebuilt."""
    diff = min_image_disp(static_block - static_ref[None], cell, cell_inv)
    return jnp.sqrt(jnp.max(jnp.sum(diff * diff, axis=-1), axis=-1))
