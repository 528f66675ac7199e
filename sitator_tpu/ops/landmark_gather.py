"""Per-vertex gather formulation of landmark assignment, in plain ``jnp``.

The path for landmark bases that share too few vertices for the tiled
unique-atom formulation (:mod:`sitator_tpu.ops.landmark_mxu`,
``mxu_supported``): gather each site's vertex coordinates, sum the masked
log-cutoffs over the vertex slots, ``exp``, then the same XLA assign stage
as the tiled path.  XLA fuses the gather, the elementwise work and the
vertex reduction into one loop; frames are processed in chunks sized from
the shapes, so the ``(B, M, S, V)`` pair tensor never exists whole.

Reference parity: the landmark vectors of
``sitator/landmark/helpers.pyx :: _fill_landmark_vectors`` (SURVEY.md §3.2).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sitator_tpu.ops.kernel_common import load_cell_params, pack_cell_params
from sitator_tpu.ops.landmark_mxu import _frame_chunks, _pair_logc, assign_lv

__all__ = ["gather_landmark_vectors", "gather_assign_blocks"]


def gather_landmark_vectors(mobile, static, verts, vmask, cell, *,
                            midpoint, steepness, cutoff_shape="logistic"):
    """Landmark vectors ``(B, M, S)`` f32.  ``cell``: (3,) orthorhombic
    lengths or (3, 3) triclinic matrix (``ops.pbc.kernel_cell``)."""
    consts = jnp.asarray([midpoint, steepness, 0.0], jnp.float32)
    params, triclinic = pack_cell_params(cell, consts)
    c, mid, steep, _thr = load_cell_params(params, triclinic)
    vp = jnp.take(static, verts, axis=1)                  # (B, S, V, 3)
    d = mobile[:, :, None, None, :] - vp[:, None]         # (B, M, S, V, 3)
    logc = _pair_logc(d[..., 0], d[..., 1], d[..., 2], c, mid, steep,
                      r2_cutoff=(cutoff_shape == "logistic_r2"),
                      triclinic=triclinic, preshift=False)
    return jnp.exp(jnp.sum(jnp.where(vmask, logc, 0.0), axis=-1))


@partial(jax.jit,
         static_argnames=("midpoint", "steepness", "threshold", "mxu_bf16",
                          "cutoff_shape", "peak_evening"))
def gather_assign_blocks(mobile, static, verts, vmask, cell, centers, *,
                         midpoint, steepness, threshold, mxu_bf16=True,
                         cutoff_shape="logistic", peak_evening="none"):
    """Landmark vectors + normalize + assign for a block of frames.

    mobile (B, M, 3), static (B, N, 3), verts (S, V) int32, vmask (S, V),
    cell: (3,) orthorhombic lengths OR (3, 3) triclinic matrix, centers
    (K, S) unit rows.  Returns (labels (B, M) int32 with −1 below
    threshold, confs (B, M)).
    """
    if peak_evening not in ("none", "clip"):
        raise ValueError(f"unknown peak_evening mode {peak_evening!r}")
    B, M, _ = mobile.shape
    S, V = verts.shape
    ct = centers.astype(jnp.float32).T

    def chunk(mobile, static):
        lv = gather_landmark_vectors(mobile, static, verts, vmask, cell,
                                     midpoint=midpoint, steepness=steepness,
                                     cutoff_shape=cutoff_shape)
        return assign_lv(lv, ct, threshold,
                         peak_clip=(peak_evening == "clip"),
                         mxu_bf16=mxu_bf16)

    # the fused pair loop keeps ~4 f32 values per (ion, site, vertex)
    return _frame_chunks(chunk, B, M * S * V * 16, mobile, static)
