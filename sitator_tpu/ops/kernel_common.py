"""Shared helpers for the tiled landmark kernel and its plain twin.

The kernel-side functions here are pure jnp expressions traced inline into
the calling code (no Pallas state of their own), so the Pallas kernel and
the plain-``jnp`` path of :mod:`sitator_tpu.ops.landmark_mxu` share one
implementation of the cell handling.  Every primitive they use has a
Pallas-Triton lowering (``floor``, not ``round``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["round_up", "pack_cell_params", "load_cell_params",
           "min_image_xyz", "lv_impl"]

#: lv-stage implementations: the compiled Pallas-Triton kernel (GPU), its
#: plain-``jnp`` twin (every other backend), or the Pallas kernel in
#: interpret mode (tests only)
LV_IMPLS = ("triton", "plain", "interpret")


def lv_impl(interpret=False):
    """The one backend-neutral choice of lv-stage implementation, shared
    by every engine: the Triton kernel on the GPU, its plain-``jnp`` twin
    elsewhere, and the Pallas interpreter only when a caller asks for it.
    There is no fallback: a kernel that fails to lower raises."""
    if interpret:
        return "interpret"
    return "triton" if jax.default_backend() == "gpu" else "plain"


def round_up(x, m):
    """Round ``x`` up to the next multiple of ``m``."""
    return (x + m - 1) // m * m


def pack_cell_params(cell, consts):
    """Trace-side: pack the cell + trailing scalar constants into the
    kernel's params vector.

    ``cell``: (3,) orthorhombic diagonal lengths or (3, 3) triclinic matrix
    (rows are lattice vectors); ``consts``: 1-D float32 array of trailing
    scalars (midpoint, steepness, threshold).  Returns
    ``(params, triclinic)``; unpack in-kernel with :func:`load_cell_params`.
    """
    cell = jnp.asarray(cell, jnp.float32)
    if cell.ndim == 2:
        cell_inv = jnp.linalg.inv(cell).astype(jnp.float32)
        return jnp.concatenate([cell.ravel(), cell_inv.ravel(), consts]), True
    return jnp.concatenate([cell, consts]), False


def load_cell_params(params_ref, triclinic):
    """Kernel-side: unpack the params vector built by
    :func:`pack_cell_params` → ``(cell, midpoint, steepness, threshold)``.

    ``cell`` is the ``(rows, inverse)`` scalar-tuple pair for triclinic
    cells, or the ``(lx, ly, lz)`` diagonal lengths otherwise — pass it
    straight to :func:`min_image_xyz`.
    """
    if triclinic:
        c = tuple(params_ref[k] for k in range(9))
        ci = tuple(params_ref[9 + k] for k in range(9))
        return (c, ci), params_ref[18], params_ref[19], params_ref[20]
    cell = (params_ref[0], params_ref[1], params_ref[2])
    return cell, params_ref[3], params_ref[4], params_ref[5]


def _nearest_int(x):
    # floor(x + 0.5): Pallas-Triton has no round lowering; it differs from
    # round-half-even only at exact half-cell ties, where both images are
    # at the same distance
    return jnp.floor(x + 0.5)


def min_image_xyz(dx, dy, dz, cell, triclinic):
    """Minimum-image displacement components (same math as
    ``ops.pbc.min_image_disp``).

    ``cell`` comes from :func:`load_cell_params`: per-axis lengths for the
    fast orthorhombic path, or the (rows, inverse) pair for the fractional
    round-trip (frac = d @ Cinv, frac -= round(frac), d = frac @ C).
    """
    if triclinic:
        c, ci = cell
        fx = dx * ci[0] + dy * ci[3] + dz * ci[6]
        fy = dx * ci[1] + dy * ci[4] + dz * ci[7]
        fz = dx * ci[2] + dy * ci[5] + dz * ci[8]
        fx = fx - _nearest_int(fx)
        fy = fy - _nearest_int(fy)
        fz = fz - _nearest_int(fz)
        dx = fx * c[0] + fy * c[3] + fz * c[6]
        dy = fx * c[1] + fy * c[4] + fz * c[7]
        dz = fx * c[2] + fy * c[5] + fz * c[8]
        return dx, dy, dz
    lx, ly, lz = cell
    dx = dx - _nearest_int(dx * (1.0 / lx)) * lx
    dy = dy - _nearest_int(dy * (1.0 / ly)) * ly
    dz = dz - _nearest_int(dz * (1.0 / lz)) * lz
    return dx, dy, dz
