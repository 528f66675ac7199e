"""Pair-correlation engines: RDF and van Hove analyses.

Engine-convention wrappers (``Engine(params).run(st)``) over the
device histogram kernels in :mod:`sitator_tpu.ops.correlation` — see
there for the physics and the device mapping.  Selections are ``'mobile'``,
``'static'``, an integer species number, or a boolean atom mask.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu.ops import correlation as corr_ops
from sitator_tpu.ops import scattering as scat_ops

__all__ = ["RDFAnalysis", "VanHoveAnalysis", "ScatteringAnalysis"]

logger = logging.getLogger(__name__)


def _resolve_mask(sel, sn):
    if isinstance(sel, str):
        if sel == "mobile":
            return np.asarray(sn.mobile_mask, dtype=bool)
        if sel == "static":
            return np.asarray(sn.static_mask, dtype=bool)
        raise ValueError(f"unknown selection {sel!r} "
                         "(use 'mobile', 'static', a species number, "
                         "or a boolean mask)")
    if np.isscalar(sel):
        mask = np.asarray(sn.structure.species) == sel
        if not mask.any():
            raise ValueError(f"no atoms of species {sel!r}")
        return mask
    mask = np.asarray(sel, dtype=bool)
    if mask.shape != (sn.structure.n_atoms,):
        raise ValueError("selection mask must be (n_atoms,)")
    return mask


def _real_traj_of(st):
    traj = st.real_trajectory
    if traj is None:
        raise ValueError(
            "SiteTrajectory has no real trajectory (set_real_traj)")
    return np.asarray(traj), st.site_network


def resolve_species_groups(st_or_traj, groups, cell):
    """Shared group handling for the multi-species transport engines
    (``OnsagerAnalysis``, ``ConductivitySpectrumAnalysis``):
    SiteTrajectory inputs resolve named selections via
    :func:`_resolve_mask`; raw trajectories take boolean masks.
    Validates mask shapes, pairwise disjointness, and that every group
    selects at least one atom.  Returns ``(traj, masks, cell, sn)``
    with ``sn`` None for raw input."""
    if hasattr(st_or_traj, "real_trajectory"):
        traj, sn = _real_traj_of(st_or_traj)
        masks = [_resolve_mask(g, sn) for g in groups]
        cell = np.asarray(sn.structure.cell)
    else:
        traj = np.asarray(st_or_traj)
        if cell is None:
            raise ValueError("raw trajectory needs cell")
        cell = np.asarray(cell)
        sn = None
        masks = []
        for g in groups:
            m = np.asarray(g)
            if m.dtype != bool or m.shape != (traj.shape[1],):
                raise ValueError(
                    "raw-trajectory groups must be (n_atoms,) boolean "
                    "masks (named selections need a SiteTrajectory)")
            masks.append(m)
    stacked = np.stack(masks)
    if (stacked.sum(axis=0) > 1).any():
        raise ValueError("species groups overlap — an atom may "
                         "belong to at most one group")
    counts = stacked.sum(axis=1)
    if (counts == 0).any():
        raise ValueError(
            f"group {int(np.argmin(counts))} selects no atoms")
    return traj, masks, cell, sn


class RDFAnalysis:
    """Radial distribution function g(r) between two selections
    (defaults: mobile–mobile).  After ``run(st)``: ``r_``, ``g_``;
    returns ``self``."""

    def __init__(self, select_a="mobile", select_b=None, r_max=None,
                 n_bins=200, exact=False, verbose=True):
        self.select_a = select_a
        self.select_b = select_b
        self.r_max = r_max
        self.n_bins = int(n_bins)
        self.exact = bool(exact)
        self.verbose = verbose

    def run(self, st):
        traj, sn = _real_traj_of(st)
        mask_a = _resolve_mask(self.select_a, sn)
        mask_b = (None if self.select_b is None
                  else _resolve_mask(self.select_b, sn))
        self.r_, self.g_ = corr_ops.rdf(
            traj, sn.structure.cell, mask_a, mask_b,
            r_max=self.r_max, n_bins=self.n_bins, exact=self.exact)
        if self.verbose:
            peak = self.r_[int(np.argmax(self.g_))]
            logger.info("g(r): first/highest peak at r = %.3f", peak)
        return self


class VanHoveAnalysis:
    """Self and distinct van Hove functions of the mobile ions at the
    given frame ``lags``.  After ``run(st)``: ``r_``, ``G_self_``
    (displacement-magnitude density, integrates to 1) and ``G_distinct_``
    (ideal gas → 1), each ``(len(lags), n_bins)``; returns ``self``."""

    def __init__(self, lags=(0, 10, 100), select="mobile", r_max=None,
                 n_bins=200, origin_stride=10, exact=False, verbose=True):
        self.lags = tuple(int(l) for l in lags)
        self.select = select
        self.r_max = r_max
        self.n_bins = int(n_bins)
        self.origin_stride = int(origin_stride)
        self.exact = bool(exact)
        self.verbose = verbose

    def run(self, st):
        traj, sn = _real_traj_of(st)
        mask = _resolve_mask(self.select, sn)
        cell = sn.structure.cell
        self.r_, self.G_self_ = corr_ops.van_hove_self(
            traj, cell, mask, self.lags, r_max=self.r_max,
            n_bins=self.n_bins, origin_stride=self.origin_stride,
            exact=self.exact)
        _, self.G_distinct_ = corr_ops.van_hove_distinct(
            traj, cell, mask, self.lags, r_max=self.r_max,
            n_bins=self.n_bins, origin_stride=self.origin_stride,
            exact=self.exact)
        if self.verbose:
            logger.info("van Hove over lags %s computed (%d bins)",
                        self.lags, self.n_bins)
        return self


class ScatteringAnalysis:
    """Reciprocal-space structure and kinetics on the lattice-
    commensurate q-grid (exact under PBC — no minimum-image truncation;
    see :mod:`sitator_tpu.ops.scattering` for the device mapping).

    Computes, shell-averaged over ``n_shells`` |q| shells up to
    ``q_max`` (inverse length units of the trajectory):

    - ``S_q_``: the static structure factor ⟨|ρ_q|²⟩/N,
    - ``F_``: the coherent intermediate scattering function
      F(q, t) = ⟨Re ρ_q(t₀+t)ρ_q*(t₀)⟩/N, shape ``(n_shells, F)``
      over ALL time origins (``F_[:, 0] == S_q_``),
    - ``phi_``: F(q, t)/S(q), the normalized relaxation of each shell,
    - ``tau_q_``: per-shell 1/e crossing time of ``phi_`` (linearly
      interpolated; NaN where it never decays that far) — the
      q-dependent structural relaxation time (de Gennes narrowing
      makes it peak at the structure-factor maximum).

    Also: ``q_`` (shell-mean |q|), ``n_q_`` (modes per shell; empty
    shells are NaN rows), ``times_``.  ``run`` needs a SiteTrajectory
    with a real trajectory attached (``set_real_traj``);
    returns ``self``.
    """

    def __init__(self, q_max, n_shells=24, q_min=0.0, select="mobile",
                 timestep=1.0, verbose=True):
        self.q_max = float(q_max)
        if self.q_max <= 0:
            raise ValueError("q_max must be positive")
        self.n_shells = int(n_shells)
        if self.n_shells < 1:
            raise ValueError("n_shells must be >= 1")
        self.q_min = float(q_min)
        self.select = select
        self.timestep = float(timestep)
        self.verbose = verbose

    def run(self, st):
        traj, sn = _real_traj_of(st)
        mask = _resolve_mask(self.select, sn)
        self.q_, self.F_, self.n_q_ = scat_ops.coherent_scattering(
            traj, sn.structure.cell, mask, self.q_max,
            n_shells=self.n_shells, q_min=self.q_min)
        self.S_q_ = self.F_[:, 0].copy()
        with np.errstate(divide="ignore", invalid="ignore"):
            self.phi_ = self.F_ / self.S_q_[:, None]
        F = self.F_.shape[1]
        self.times_ = np.arange(F, dtype=np.float64) * self.timestep
        from sitator_tpu.dynamics.diffusion import RelaxationAnalysis
        self.tau_q_ = np.array([
            RelaxationAnalysis._crossing_time(
                self.times_, self.phi_[s], 1.0 / np.e)
            if np.isfinite(self.phi_[s]).all() else float("nan")
            for s in range(self.n_shells)])
        if self.verbose:
            ok = np.isfinite(self.S_q_)
            if ok.any():
                peak = int(np.nanargmax(np.where(ok, self.S_q_, -np.inf)))
                logger.info(
                    "S(q): %d modes in %d shells; peak S=%.3g at "
                    "q=%.3g; tau there %.3g",
                    int(self.n_q_.sum()), self.n_shells,
                    self.S_q_[peak], self.q_[peak], self.tau_q_[peak])
        return self
