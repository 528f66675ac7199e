"""Tiled unique-atom landmark formulation — the production hot path.

Instead of recomputing every (ion, site, vertex) distance, this exploits
vertex SHARING: neighbouring landmark polyhedra reuse the same static atoms
(8 sites per atom on a simple-cubic lattice), so a spatially compact tile
of 128 sites touches only ~225 unique atoms — not 1024 vertex slots.

Per (frame, ion block, site tile):

1. distance core on the tile's **unique vertex atoms** only:
   ``logc[m, u] = −softplus(k (d(m,u)² − d0²))``    (M, U)
2. the product over each site's vertices is a **matmul in log space**
   against the tile-local membership matrix:
   ``loglv = logc @ A_t``  with ``A_t (U, S_t)`` ∈ {0, 1, 2…}
   (multiplicity reproduces repeated vertex factors; masked slots simply
   never enter A);
3. ``lv = exp(loglv)``, padded site columns killed to 0.

That lv stage has two implementations with one contract: a Pallas kernel
compiled through Triton for the GPU (``logc`` stays in registers; the grid
is (frame, ion block, site tile), all parallel, with a loop over
unique-atom chunks inside each program), and its plain-``jnp`` twin, which
XLA compiles on every other backend.  :func:`kernel_common.lv_impl` picks
one; the Pallas kernel runs in interpret mode only when a caller asks.

Assignment stays in XLA on top of the lv stage: row norm, one
``(B·M, SP) @ (SP, K)`` similarity product (bf16 operands, f32
accumulation), argmax and threshold; ``peak_evening='clip'`` caps each row
at its second-largest entry first (``lax.top_k``).  Frames are processed in
chunks sized from the shapes, so device memory stays bounded at any block
size.

Host-side prep (once per landmark basis): order the sites by a balanced
kd split so every tile is a compact axis-aligned box, extract each tile's
unique-atom list, and build the padded per-tile ``A``.
:func:`mxu_supported` reports when the basis shares enough vertices for
this formulation to win; callers take the plain gather path otherwise.

Reference parity: this computes exactly the landmark vectors of
``sitator/landmark/helpers.pyx :: _fill_landmark_vectors`` (SURVEY.md
§3.2) — only the execution schedule is different.
"""
from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from sitator_tpu.ops.kernel_common import (LV_IMPLS, load_cell_params,
                                           lv_impl, min_image_xyz,
                                           pack_cell_params,
                                           round_up as _round_up)

logger = logging.getLogger(__name__)

__all__ = ["prepare_mxu_basis", "prepare_engine_basis",
           "mxu_assign_blocks", "mxu_supported",
           "permute_centers", "mxu_landmark_blocks",
           "tiled_landmark_vectors"]

_HIGHEST = jax.lax.Precision.HIGHEST
_BM = 64          # ion rows per kernel program
_BK = 32          # unique atoms per inner-loop step (a multiple of 16)
_NUM_WARPS = 4
_N_PARAMS = 32    # params vector padded to a power of two
_CHUNK_BYTES = 1 << 30   # device bytes of per-chunk lv (+ plain logc)


def _pow2_at_least(n, lo):
    p = lo
    while p < n:
        p *= 2
    return p


def _kd_order(frac, s_tile):
    """Balanced kd-split site ordering: recursively split the site set
    along its widest fractional axis at exact ``s_tile`` multiples, so
    every consecutive ``s_tile`` slice of the returned permutation is a
    compact axis-aligned box.  (A Morton curve sliced at arbitrary tile
    offsets straddles octant jumps — tiles spanning half the cell — which
    both inflates per-tile unique-atom counts and breaks the preshift
    bound; the kd split bounds every tile's extent by construction.)"""
    S = len(frac)
    n_tiles = -(-S // s_tile)
    out = []

    def rec(ids, k):
        if k == 1:
            out.append(ids)
            return
        f = frac[ids]
        ax = int(np.argmax(f.max(axis=0) - f.min(axis=0)))
        k1 = k // 2
        n_left = min(k1 * s_tile, len(ids))
        o = ids[np.argsort(f[:, ax], kind="stable")]
        rec(o[:n_left], k1)
        rec(o[n_left:], k - k1)

    rec(np.arange(S), n_tiles)
    return np.concatenate(out)


def _tile_geometry(verts, vmask, site_pos, cell, s_tile, static_ref=None):
    """Host-side kd-tiling analysis shared by :func:`choose_s_tile` and
    :func:`prepare_mxu_basis` — ONE implementation, so the cost model can
    never drift from the real tiling.  Returns the site ordering, the
    per-tile unique-atom lists and padded sizes; given ``static_ref``,
    also the anchor-unwrapped per-tile reference geometry
    (``ref_u``/``anchors``/``rfrac``) that the preshift bound needs."""
    verts = np.asarray(verts)
    vmask = np.asarray(vmask).astype(bool)
    site_pos = np.asarray(site_pos, np.float64)
    cell = np.asarray(cell, np.float64)
    S, V = verts.shape
    inv = np.linalg.inv(cell)
    frac = (site_pos @ inv) % 1.0
    order = _kd_order(frac, s_tile)
    verts_s = verts[order]
    vmask_s = vmask[order]
    SP = _round_up(S, s_tile)
    n_st = SP // s_tile
    uniq = []
    for t in range(n_st):
        lo, hi = t * s_tile, min((t + 1) * s_tile, S)
        if lo >= S:
            uniq.append(np.zeros(0, np.int64))
            continue
        uniq.append(np.unique(verts_s[lo:hi][vmask_s[lo:hi]]))
    # a power of two: the kernel's block over the unique-atom axis
    UP = _pow2_at_least(max((len(u) for u in uniq), default=1), _BK)
    g = dict(order=order, verts_s=verts_s, vmask_s=vmask_s, uniq=uniq,
             S=S, V=V, SP=SP, n_st=n_st, UP=UP)
    if static_ref is None:
        return g
    static_ref = np.asarray(static_ref, np.float64)
    site_frac = site_pos @ inv                   # NOT wrapped
    ref_frac = static_ref @ inv
    ref_u = np.zeros((n_st, UP, 3), np.float64)
    anchors = np.zeros((n_st, 3), np.float64)
    rfrac = np.zeros(3)
    for t in range(n_st):
        lo, hi = t * s_tile, min((t + 1) * s_tile, S)
        u = uniq[t]
        if lo >= S or len(u) == 0:
            continue
        # anchor: fractional centroid of the tile's sites, each unwrapped
        # to the first site's image (kd tiles are compact boxes, but may
        # still touch a face)
        sf = site_frac[order[lo:hi]]
        sf = sf - np.round(sf - sf[0])
        anchor_f = sf.mean(axis=0)
        af = ref_frac[u]
        af = af - np.round(af - anchor_f)        # unwrap atoms to anchor
        rfrac = np.maximum(rfrac, np.abs(af - anchor_f).max(axis=0))
        ref_u[t, :len(u)] = af @ cell
        # padded slots replay atom 0's coords; A never references them
        ref_u[t, len(u):] = ref_u[t, 0]
        anchors[t] = anchor_f @ cell
    g.update(ref_u=ref_u, anchors=anchors, rfrac=rfrac)
    return g


def _preshift_log_bound(rfrac, cell, midpoint, steepness, cutoff_shape,
                        vibration_margin):
    """log-cutoff value at the nearest distance any wrong-image pair can
    have under this tiling (see :func:`prepare_mxu_basis`); the preshift
    route is exact when this is ≤ −75."""
    cell = np.asarray(cell, np.float64)
    w = 1.0 / np.linalg.norm(np.linalg.inv(cell), axis=0)
    half_gap = 0.5 - rfrac - vibration_margin / w
    if not (half_gap > 0.0).all():
        return 0.0
    d_far = float(np.min(half_gap * w))
    if cutoff_shape == "logistic_r2":
        k2 = steepness / (2.0 * midpoint)
        return -(k2 * (d_far * d_far - midpoint * midpoint))
    return -(steepness * (d_far - midpoint))


def choose_s_tile(verts, vmask, site_pos, cell,
                  candidates=(128, 256), vpu_weight=25.0,
                  static_ref=None, midpoint=None, steepness=None,
                  cutoff_shape="logistic", vibration_margin=3.0):
    """Per-basis s_tile/UP co-tuning by a host-side cost model.

    For each candidate tile size, compute the real kd tiling's unique-atom
    padding ``UP`` and tile count ``n_st`` (via the same
    :func:`_tile_geometry` the basis builder uses) and score the per-ion
    work:

        cost = vpu_weight · 12 · (UP · n_st)     # distance+cutoff pairs
             + 2 · UP · SP                       # membership matmul
             + 2 · SP · S                        # similarity matmul proxy
                                                 # (K unknown here; K ~ S)

    ``vpu_weight`` weighs an elementwise FLOP against a matmul FLOP.  At
    the simple-cubic flagship basis 128 dominates 256 in both terms (256
    doubles UP), so the choice does not depend on the weight.

    Candidates are powers of two: ``s_tile`` is a block dimension of the
    Triton kernel.

    When the preshift inputs (``static_ref`` + cutoff parameters) are
    given, any candidate that keeps the preshift bound beats every
    candidate that loses it, regardless of modeled cost.
    """
    check_ps = (static_ref is not None and midpoint is not None
                and steepness is not None)
    best = None
    for st in candidates:
        g = _tile_geometry(verts, vmask, site_pos, cell, st,
                           static_ref if check_ps else None)
        cost = (vpu_weight * 12.0 * g["UP"] * g["n_st"]
                + 2.0 * g["UP"] * g["SP"] + 2.0 * g["SP"] * g["S"])
        loses_preshift = check_ps and _preshift_log_bound(
            g["rfrac"], cell, midpoint, steepness, cutoff_shape,
            vibration_margin) > -75.0
        key = (loses_preshift, cost)
        if best is None or key < best[0]:
            best = (key, st)
    return best[1]


def prepare_mxu_basis(verts, vmask, site_pos, cell, *, s_tile=256,
                      static_ref=None, midpoint=None,
                      steepness=None, cutoff_shape="logistic",
                      vibration_margin=3.0):
    """Host-side, once per landmark basis.

    verts (S, V) int32 indices into the static substructure, vmask (S, V),
    site_pos (S, 3) landmark node positions (used only for the spatial
    kd tiling — any representative per-site point works),
    cell (3, 3).  Returns a dict with device arrays:

    - ``uidx (n_st, UP)``: per-tile unique static-atom indices (0-padded);
    - ``A (n_st, UP, s_tile)``: tile-local vertex-membership/multiplicity;
    - ``kill (SP,)``: 1.0 on padded site columns;
    - ``site_order (S,)``: permutation applied to the site axis — apply to
      cluster-center COLUMNS via :func:`permute_centers`;
    plus static metadata (``s_tile``, ``n_st``, ``UP``, cost ratio).

    **Tile-preshift route** (enabled when ``static_ref`` — the reference
    (n_static, 3) positions — and the cutoff parameters are given, and the
    cell is big enough): each tile's atoms are unwrapped once to the image
    nearest the tile anchor, so the lv stage replaces the per-(ion, atom)
    minimum image (3·M·U roundings per tile) with ONE shift per (ion, tile).
    Exact by the underflow argument: a pair for which the single shift is
    not the minimum image has BOTH its raw and true min-image distances
    ≥ ``d_far = min_ax (0.5 − r_frac − vib_frac) · w_ax`` (inscribed cell
    widths ``w``); if ``log cutoff(d_far) ≤ −75``, the entry is ≤ 2.7e−33
    in either formulation — orders of magnitude below anything that can
    move an f32 assignment (see the bound's in-code note) — so labels are
    unchanged.  ``vibration_margin`` (Å) budgets per-frame
    static-atom drift on top of the reference geometry (the engines'
    ``static_movement_threshold`` guard keeps real drift far below it).
    Small cells fail the bound and take the per-pair path
    (``preshift=False``).
    """
    have_ref = (static_ref is not None and midpoint is not None
                and steepness is not None)
    g = _tile_geometry(verts, vmask, site_pos, cell, s_tile,
                       static_ref if have_ref else None)
    S, V = g["S"], g["V"]
    SP, n_st, UP = g["SP"], g["n_st"], g["UP"]
    order, uniq = g["order"], g["uniq"]
    verts_s, vmask_s = g["verts_s"], g["vmask_s"]

    uidx = np.zeros((n_st, UP), np.int32)
    A = np.zeros((n_st, UP, s_tile), np.float32)
    for t in range(n_st):
        u = uniq[t]
        if len(u) == 0:
            continue
        uidx[t, :len(u)] = u
        lo, hi = t * s_tile, min((t + 1) * s_tile, S)
        vs = verts_s[lo:hi]
        vm = vmask_s[lo:hi]
        row = np.searchsorted(u, vs)            # (st_real, V)
        cols = np.broadcast_to(np.arange(hi - lo)[:, None], vs.shape)
        np.add.at(A, (t, row[vm], cols[vm]), 1.0)
    kill = np.zeros((SP,), np.float32)
    kill[S:] = 1.0

    basis = dict(
        uidx=jnp.asarray(uidx),
        A=jnp.asarray(A),
        kill=jnp.asarray(kill),
        site_order=order,
        inv_order=jnp.asarray(np.argsort(order), jnp.int32),
        s_tile=int(s_tile),
        n_st=int(n_st),
        UP=int(UP),
        # elementwise-pair cost vs the gather path (lower = tiled wins)
        cost_ratio=float(n_st * UP) / float(max(S * V, 1)),
        preshift=False,
    )

    if not have_ref:
        return basis
    # −75: a disagreeing pair contributes lv ≤ exp(−75) ≈ 2.7e−33 in
    # EITHER formulation, perturbing any similarity by < S·2.7e−33
    # ≈ 1e−28 total — an f32 argmax between values above ~1e−21 cannot
    # be flipped by that (ulp(1e−21) ≈ 1e−28), and confidences at
    # 1e−21 are unassignable noise in any real configuration.  Agreeing
    # pairs are the same minimum image computed either way (ulp-level
    # arithmetic reordering only).
    if _preshift_log_bound(g["rfrac"], cell, midpoint, steepness,
                           cutoff_shape, vibration_margin) <= -75.0:
        basis["preshift"] = True
        basis["ref_u"] = jnp.asarray(g["ref_u"], jnp.float32)
        basis["anchors"] = jnp.asarray(g["anchors"], jnp.float32)
    return basis


def prepare_engine_basis(verts, vmask, site_pos, cell, *, midpoint,
                         steepness, cutoff_shape, static_ref=None,
                         drift_budget=None, s_tile="auto"):
    """One-stop tiled-route gate shared by every engine
    (``LandmarkAnalysis``, streaming fit + stream passes,
    ``SpmdLandmarkPipeline``): builds the kd basis with the preshift
    drift budget tied to the caller's drift guard
    (``vibration_margin = max(3, 2·budget)``; ``drift_budget=None`` ⇒
    preshift disabled, since nothing bounds static-atom drift), and
    returns None when the basis does not share enough vertices for the
    tiled route (:func:`mxu_supported`).  Keeping this policy in ONE place
    is what stops the engines' budgets from drifting apart.

    ``s_tile='auto'`` co-tunes the tile size per basis via
    :func:`choose_s_tile` (picks 128 at the flagship SC basis),
    preferring candidates that keep the preshift bound."""
    vib = (max(3.0, 2.0 * float(drift_budget))
           if drift_budget is not None else 3.0)
    if s_tile == "auto":
        s_tile = choose_s_tile(
            verts, vmask, site_pos, cell,
            static_ref=static_ref if drift_budget is not None else None,
            midpoint=midpoint, steepness=steepness,
            cutoff_shape=cutoff_shape, vibration_margin=vib)
    basis = prepare_mxu_basis(
        verts, vmask, site_pos, cell, s_tile=s_tile,
        static_ref=static_ref if drift_budget is not None else None,
        midpoint=midpoint, steepness=steepness, cutoff_shape=cutoff_shape,
        vibration_margin=vib)
    ok = mxu_supported(basis)
    logger.debug(
        "tiled-route gate: tiled=%s (cost_ratio %.3f), preshift=%s "
        "(drift budget %s)", ok, basis["cost_ratio"],
        basis["preshift"] if ok else "-", drift_budget)
    return basis if ok else None


def mxu_supported(basis, max_cost_ratio=0.75) -> bool:
    """True when the unique-atom formulation does less elementwise work
    than the gather path (vertex sharing is high enough).  Bases with no
    sharing (U → S·V) degrade past the gather path — take it there."""
    return basis["cost_ratio"] <= max_cost_ratio


def permute_centers(centers, basis):
    """Permute cluster-center COLUMNS into the basis's kd-tile site order
    (labels index center ROWS and need no remapping)."""
    return np.asarray(centers)[:, basis["site_order"]]


# --------------------------------------------------------------- lv stage

def _softplus(x):
    # jax.nn.softplus's formula, spelled with primitives every backend
    # (Pallas-Triton included) lowers
    return jnp.maximum(x, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(x)))


def _pair_logc(dx, dy, dz, cell, midpoint, steepness, *, r2_cutoff,
               triclinic, preshift):
    """log-cutoff of every (ion, atom) pair from raw coordinate
    differences — shared VERBATIM by the Pallas kernel and its plain
    twin, so the two can never drift apart.  With ``preshift`` the
    differences are already minimum images (see :func:`prepare_mxu_basis`)."""
    if not preshift:
        dx, dy, dz = min_image_xyz(dx, dy, dz, cell, triclinic)
    d2 = dx * dx + dy * dy + dz * dz
    if r2_cutoff:
        k2 = steepness / (2.0 * midpoint)
        x = k2 * d2 - k2 * (midpoint * midpoint)
    else:
        x = steepness * (jnp.sqrt(d2) - midpoint)
    return -_softplus(x)


def _shift_to_anchor(mx, my, mz, ax, ay, az, cell, triclinic):
    """ONE min-image per (ion, tile): the ion's image nearest the tile
    anchor (the tile's atoms were unwrapped to that anchor)."""
    sx, sy, sz = min_image_xyz(mx - ax, my - ay, mz - az, cell, triclinic)
    return ax + sx, ay + sy, az + sz


def _bf16_head(x):
    # x truncated to its top 8 mantissa bits: exactly representable in
    # bf16, so the later casts are exact (and XLA's licence to skip
    # f32->bf16->f32 round trips cannot change the split)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    return jax.lax.bitcast_convert_type(bits & jnp.int32(-65536),
                                        jnp.float32)


def _split3(x):
    """Exact split of f32 ``x`` into three bf16 terms (8 + 8 + 8 mantissa
    bits): ``x == hi + mid + lo``."""
    hi = _bf16_head(x)
    r = x - hi
    mid = _bf16_head(r)
    return (hi.astype(jnp.bfloat16), mid.astype(jnp.bfloat16),
            (r - mid).astype(jnp.bfloat16))


def _log_product(logc, A, dot):
    """The log-space membership product at f32 accuracy on bf16 tensor
    cores: ``A`` holds small integers (exact in bf16), so three bf16
    products of the exact split of ``logc`` (:func:`_split3`), accumulated
    in f32, equal the f32 product to accumulation rounding.  (A plain f32
    product in a Triton kernel runs in TF32, ~3 significant digits, or on
    the FMA units at HIGHEST, which PERF.md measures slower.)"""
    parts = _split3(logc)
    acc = dot(parts[0], A)
    for p in parts[1:]:
        acc = acc + dot(p, A)
    return acc


def _lv_kernel(mob_ref, vpu_ref, A_ref, kill_ref, anchors_ref, params_ref,
               lv_ref, *, n_k, r2_cutoff, triclinic, preshift):
    """One (frame, ion block, site tile) program: ``lv (BM, s_tile)``.
    The unique-atom axis is walked in ``_BK`` chunks, so ``logc`` never
    leaves registers; the log-space product accumulates in f32."""
    cell, midpoint, steepness, _thr = load_cell_params(params_ref,
                                                       triclinic)
    mx = mob_ref[0, :]
    my = mob_ref[1, :]
    mz = mob_ref[2, :]
    if preshift:
        mx, my, mz = _shift_to_anchor(mx, my, mz, anchors_ref[0],
                                      anchors_ref[1], anchors_ref[2],
                                      cell, triclinic)

    def body(k, acc):
        sl = pl.ds(k * _BK, _BK)
        logc = _pair_logc(mx[:, None] - vpu_ref[0, sl][None, :],
                          my[:, None] - vpu_ref[1, sl][None, :],
                          mz[:, None] - vpu_ref[2, sl][None, :],
                          cell, midpoint, steepness, r2_cutoff=r2_cutoff,
                          triclinic=triclinic, preshift=preshift)
        return acc + _log_product(
            logc, A_ref[sl, :], lambda a, b: jax.lax.dot_general(
                a, b, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32))

    acc = jax.lax.fori_loop(
        0, n_k, body, jnp.zeros((mx.shape[0], A_ref.shape[1]), jnp.float32))
    lv = jnp.where(kill_ref[...][None, :] > 0.0, 0.0, jnp.exp(acc))
    lv_ref[...] = lv.astype(lv_ref.dtype)


def _lv_pallas(mobile, vpu, A, kill, anchors, params, *, r2_cutoff,
               triclinic, preshift, out_dtype, interpret):
    B, M, _ = mobile.shape
    n_st, UP, s_tile = A.shape
    MP = _round_up(M, _BM)
    # coordinate planes padded to 4 rows (block dims are powers of two);
    # padded ions repeat the last one and are sliced off below
    mob = jnp.pad(jnp.transpose(mobile, (0, 2, 1)),
                  ((0, 0), (0, 1), (0, MP - M)), mode="edge")
    vp = jnp.pad(jnp.transpose(vpu, (0, 1, 3, 2)),
                 ((0, 0), (0, 0), (0, 1), (0, 0)))          # (B,n_st,4,UP)
    anc = jnp.pad(anchors, ((0, 0), (0, 1)))
    prm = jnp.pad(params, (0, _N_PARAMS - params.shape[0]))
    kernel = partial(_lv_kernel, n_k=UP // _BK, r2_cutoff=r2_cutoff,
                     triclinic=triclinic, preshift=preshift)
    lv = pl.pallas_call(
        kernel,
        grid=(B, MP // _BM, n_st),
        in_specs=[
            pl.BlockSpec((None, 4, _BM), lambda b, m, t: (b, 0, m)),
            pl.BlockSpec((None, None, 4, UP), lambda b, m, t: (b, t, 0, 0)),
            pl.BlockSpec((None, UP, s_tile), lambda b, m, t: (t, 0, 0)),
            pl.BlockSpec((s_tile,), lambda b, m, t: (t,)),
            pl.BlockSpec((None, 4), lambda b, m, t: (t, 0)),
            pl.BlockSpec((_N_PARAMS,), lambda b, m, t: (0,)),
        ],
        out_specs=pl.BlockSpec((None, _BM, s_tile),
                               lambda b, m, t: (b, m, t)),
        out_shape=jax.ShapeDtypeStruct((B, MP, n_st * s_tile), out_dtype),
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=2),
        interpret=interpret,
        name="landmark_lv_tile",
    )(mob, vp, A, kill, anc, prm)
    return lv[:, :M]


def _lv_plain(mobile, vpu, A, kill, anchors, params, *, r2_cutoff,
              triclinic, preshift, out_dtype):
    """The kernel's plain-``jnp`` twin: same math, scheduled by XLA
    (``logc (B, M, n_st, UP)`` is materialized before the batched
    membership product)."""
    B, M, _ = mobile.shape
    n_st, UP, s_tile = A.shape
    cell, midpoint, steepness, _thr = load_cell_params(params, triclinic)
    mx, my, mz = (mobile[:, :, None, None, k] for k in range(3))
    if preshift:
        mx, my, mz = _shift_to_anchor(
            mx, my, mz, *(anchors[None, None, :, None, k] for k in range(3)),
            cell, triclinic)                           # (B, M, n_st, 1)
    logc = _pair_logc(mx - vpu[:, None, :, :, 0], my - vpu[:, None, :, :, 1],
                      mz - vpu[:, None, :, :, 2], cell, midpoint, steepness,
                      r2_cutoff=r2_cutoff, triclinic=triclinic,
                      preshift=preshift)               # (B, M, n_st, UP)
    # f32 at HIGHEST (on a GPU XLA's fastest plain form of this product,
    # measured against the kernel's bf16 split)
    loglv = jnp.einsum("bmtu,tus->bmts", logc, A.astype(jnp.float32),
                       precision=_HIGHEST,
                       preferred_element_type=jnp.float32)
    lv = jnp.exp(loglv.reshape(B, M, n_st * s_tile))
    return jnp.where(kill > 0.0, 0.0, lv).astype(out_dtype)


def _gather_tile_atoms(static, uidx, ref_u, cell, preshift):
    """Each tile's unique-atom coordinates ``(B, n_st, UP, 3)``; with
    preshift, re-unwrapped to the image nearest their unwrapped reference
    (robust to arbitrary wrapping + drift in the input)."""
    B = static.shape[0]
    n_st, UP = uidx.shape
    vpu = jnp.take(static, uidx.reshape(-1), axis=1).reshape(B, n_st, UP, 3)
    if preshift:
        cm = jnp.diag(cell) if cell.ndim == 1 else cell
        f = jnp.matmul(vpu - ref_u[None], jnp.linalg.inv(cm),
                       precision=_HIGHEST)
        vpu = ref_u[None] + jnp.matmul(f - jnp.floor(f + 0.5), cm,
                                       precision=_HIGHEST)
    return vpu


def tiled_landmark_vectors(mobile, static, uidx, A, kill, cell, ref_u,
                           anchors, *, midpoint, steepness,
                           cutoff_shape="logistic", preshift=False,
                           impl="plain", out_dtype=jnp.float32):
    """Landmark vectors ``(B, M, SP)`` with columns in kd-tile order
    (padded columns are exactly 0) — the lv stage shared by the assign and
    lv-emitting entry points.  ``impl`` is one of
    :data:`kernel_common.LV_IMPLS`.  The log-space membership product is
    f32-accurate (:func:`_log_product`): these products decide labels."""
    if impl not in LV_IMPLS:
        raise ValueError(f"unknown lv impl {impl!r}")
    vpu = _gather_tile_atoms(static, uidx, ref_u, cell, preshift)
    consts = jnp.asarray([midpoint, steepness, 0.0], jnp.float32)
    params, triclinic = pack_cell_params(cell, consts)
    kw = dict(r2_cutoff=(cutoff_shape == "logistic_r2"), triclinic=triclinic,
              preshift=preshift, out_dtype=out_dtype)
    A = A.astype(jnp.bfloat16)          # small integers: exact
    if impl == "plain":
        return _lv_plain(mobile, vpu, A, kill, anchors, params, **kw)
    return _lv_pallas(mobile, vpu, A, kill, anchors, params,
                      interpret=(impl == "interpret"), **kw)


def _frame_chunks(fn, B, per_frame_bytes, *arrays):
    """Apply ``fn`` to frame chunks of the leading axis of ``arrays``
    (``lax.map`` over chunks sized so one chunk's intermediates stay near
    ``_CHUNK_BYTES``; the tail is edge-padded and sliced off)."""
    c = int(min(B, max(1, _CHUNK_BYTES // max(per_frame_bytes, 1))))
    n = -(-B // c)
    c = -(-B // n)
    if n == 1:
        return fn(*arrays)
    pad = n * c - B
    xs = [jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1), mode="edge")
          .reshape((n, c) + a.shape[1:]) for a in arrays]
    out = jax.lax.map(lambda xs: fn(*xs), xs)
    return jax.tree.map(lambda o: o.reshape((n * c,) + o.shape[2:])[:B],
                        out)


def _per_frame_bytes(M, n_st, UP, s_tile, lv_bytes, impl):
    b = M * n_st * s_tile * (lv_bytes + 4)
    if impl == "plain":
        b += 2 * M * n_st * UP * 4     # materialized logc (+ a copy)
    return b


def _basis_arrays(basis):
    preshift = bool(basis.get("preshift", False))
    n_st = basis["n_st"]
    ref_u = (basis["ref_u"] if preshift
             else jnp.zeros((n_st, basis["UP"], 3), jnp.float32))
    anchors = (basis["anchors"] if preshift
               else jnp.zeros((n_st, 3), jnp.float32))
    return preshift, ref_u, anchors


@partial(jax.jit,
         static_argnames=("midpoint", "steepness", "impl", "cutoff_shape",
                          "preshift"))
def _mxu_lv_call(mobile, static, uidx, A, kill, cell, ref_u, anchors,
                 inv_order, *, midpoint, steepness, impl,
                 cutoff_shape="logistic", preshift=False):
    B, M, _ = mobile.shape
    n_st, UP, s_tile = A.shape

    def chunk(mobile, static):
        lv = tiled_landmark_vectors(
            mobile, static, uidx, A, kill, cell, ref_u, anchors,
            midpoint=midpoint, steepness=steepness,
            cutoff_shape=cutoff_shape, preshift=preshift, impl=impl)
        # back to the caller's site order (columns are in kd-tile order)
        return lv[:, :, inv_order]

    return _frame_chunks(chunk, B,
                         _per_frame_bytes(M, n_st, UP, s_tile, 4, impl),
                         mobile, static)


def mxu_landmark_blocks(mobile, static, basis, cell, *, midpoint,
                        steepness, interpret=False,
                        cutoff_shape="logistic"):
    """Landmark vectors ``(B, M, S)`` f32 in the CALLER's site order via
    the tiled lv stage (at HIGHEST precision) — the path for
    ``LandmarkAnalysis``'s reference-parity ``.landmark_vectors`` contract
    and the streaming fit pass.  Normalization / peak evening / clustering
    stay in XLA on top."""
    preshift, ref_u, anchors = _basis_arrays(basis)
    inv_order = basis.get("inv_order")
    if inv_order is None:   # hand-built basis dicts (tests/bench harnesses)
        inv_order = jnp.asarray(
            np.argsort(np.asarray(basis["site_order"])), jnp.int32)
    return _mxu_lv_call(
        mobile, static, basis["uidx"], basis["A"], basis["kill"], cell,
        ref_u, anchors, inv_order, midpoint=float(midpoint),
        steepness=float(steepness), impl=lv_impl(interpret),
        cutoff_shape=cutoff_shape, preshift=preshift)


# ----------------------------------------------------------- assign stage

def assign_lv(lv, centers_t, threshold, *, peak_clip, mxu_bf16):
    """XLA assign on top of the lv stage: optional top-2 clip, row norm,
    one similarity product, argmax and threshold.

    ``lv (..., SP)``; ``centers_t (SP, K)`` unit centers, transposed.  The
    similarity runs with bf16 operands and f32 accumulation when
    ``mxu_bf16`` (production), else in f32 at HIGHEST precision.  The norm
    is taken in f32 of the lv as the similarity consumes it, so the
    confidence is the exact cosine of those operands."""
    if peak_clip:
        cap = jax.lax.top_k(lv, 2)[0][..., 1:2]
        lv = jnp.minimum(lv, cap)
    sdt = jnp.bfloat16 if mxu_bf16 else jnp.float32
    lv = lv.astype(sdt)
    lvf = lv.astype(jnp.float32)
    norm2 = jnp.sum(lvf * lvf, axis=-1)
    sims = jax.lax.dot_general(
        lv, centers_t.astype(sdt), (((lv.ndim - 1,), (0,)), ((), ())),
        precision=None if mxu_bf16 else _HIGHEST,
        preferred_element_type=jnp.float32)
    sims = sims * jax.lax.rsqrt(jnp.maximum(norm2, 1e-24))[..., None]
    conf = jnp.max(sims, axis=-1)
    lab = jnp.argmax(sims, axis=-1).astype(jnp.int32)
    return jnp.where(conf >= threshold, lab, -1), conf


@partial(jax.jit,
         static_argnames=("midpoint", "steepness", "threshold", "mxu_bf16",
                          "impl", "cutoff_shape", "peak_evening",
                          "preshift"))
def _mxu_call(mobile, static, uidx, A, kill, cell, centers_perm, ref_u,
              anchors, *, midpoint, steepness, threshold, mxu_bf16=True,
              impl="plain", cutoff_shape="logistic", peak_evening="none",
              preshift=False):
    if peak_evening not in ("none", "clip"):
        raise ValueError(f"unknown peak_evening mode {peak_evening!r}")
    B, M, _ = mobile.shape
    n_st, UP, s_tile = A.shape
    SP = n_st * s_tile
    # (SP, K): padded site rows are zero, like the killed lv columns
    ct = jnp.pad(centers_perm.astype(jnp.float32).T,
                 ((0, SP - centers_perm.shape[1]), (0, 0)))
    lv_dtype = jnp.bfloat16 if mxu_bf16 else jnp.float32

    def chunk(mobile, static):
        lv = tiled_landmark_vectors(
            mobile, static, uidx, A, kill, cell, ref_u, anchors,
            midpoint=midpoint, steepness=steepness,
            cutoff_shape=cutoff_shape, preshift=preshift, impl=impl,
            out_dtype=lv_dtype)
        return assign_lv(lv, ct, threshold,
                         peak_clip=(peak_evening == "clip"),
                         mxu_bf16=mxu_bf16)

    lv_bytes = jnp.dtype(lv_dtype).itemsize
    return _frame_chunks(
        chunk, B, _per_frame_bytes(M, n_st, UP, s_tile, lv_bytes, impl),
        mobile, static)


def mxu_assign_blocks(mobile, static, basis, cell, centers_perm, *,
                      midpoint, steepness, threshold, mxu_bf16=True,
                      interpret=False, cutoff_shape="logistic",
                      peak_evening="none"):
    """Tiled landmark stage + XLA normalize/assign.

    ``basis`` from :func:`prepare_mxu_basis`; ``centers_perm`` (K, S) unit
    cluster centers with columns permuted by :func:`permute_centers`.
    ``cell``: (3,) orthorhombic lengths or (3, 3) triclinic.  Returns
    (labels (B, M) int32 with −1 below threshold, confs (B, M)) — labels
    index center rows, identical to the gather path's.
    """
    preshift, ref_u, anchors = _basis_arrays(basis)
    return _mxu_call(
        mobile, static, basis["uidx"], basis["A"], basis["kill"], cell,
        jnp.asarray(centers_perm, jnp.float32), ref_u, anchors,
        midpoint=float(midpoint), steepness=float(steepness),
        threshold=float(threshold), mxu_bf16=mxu_bf16,
        impl=lv_impl(interpret), cutoff_shape=cutoff_shape,
        peak_evening=peak_evening, preshift=preshift)
