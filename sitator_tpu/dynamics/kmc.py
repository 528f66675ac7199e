"""Kinetic Monte Carlo resampling of an analyzed site network.

Beyond-reference closure/extrapolation tool (upstream ``sitator`` stops at
the jump statistics, SURVEY.md §3.4): take the frame-resolution Markov
chain that :class:`~sitator_tpu.dynamics.JumpAnalysis` measured — hop
counts ``n_ij`` over total residence frames — and *resample* it on
device.  Uses:

- **closure validation**: re-running ``JumpAnalysis`` /
  ``SiteDiffusionAnalysis`` on the resampled trajectory must reproduce
  the input jump rates, occupancies and site-discretized diffusivity —
  a self-consistency check of the whole site decomposition;
- **statistics extrapolation**: generate arbitrarily many walkers /
  frames from a short MD run to tighten rare-event statistics
  (pathway percolation, barrier estimates) at MD-free cost.

The observed process *at frame resolution* is a discrete-time Markov
chain whose maximum-likelihood transition matrix follows directly from
the JumpAnalysis attributes: ``P[i,j] = n_ij[i,j] / t_i`` for ``j ≠ i``
(``t_i`` = ``total_corrected_residences[i]``, frames spent at ``i``) and
``P[i,i] = 1 − Σ_{j≠i} P[i,j]``.  Simulating THIS chain — rather than an
underlying continuous-time model — makes the closure exact in
expectation: what JumpAnalysis measures on the output converges to what
it measured on the input.

On device: the walk is one ``lax.scan`` over frames, all walkers
advanced in parallel by Gumbel-max categorical draws on the dense
``(W, S)`` logit gather; runs equally on the CPU backend.
"""
from __future__ import annotations

import logging

import numpy as np

from sitator_tpu.core.sitenet import SiteNetwork
from sitator_tpu.core.sitetraj import SiteTrajectory
from sitator_tpu.core.structure import Structure

logger = logging.getLogger(__name__)

__all__ = ["KineticMonteCarlo", "transition_matrix_from_network",
           "mean_first_passage_times"]


def transition_matrix_from_network(sn):
    """Maximum-likelihood frame-resolution transition matrix ``(S, S)``
    from the ``n_ij`` / ``total_corrected_residences`` attributes that
    :class:`JumpAnalysis` wrote onto ``sn``.

    Rows of never-visited sites (zero residence) are made absorbing
    (``P[i,i] = 1``) — a walker can never start there anyway when
    starting from occupancies.  If a row's off-diagonal mass exceeds 1
    (more recorded jumps out of a site than frames spent there — only
    possible for pathological inputs), it is renormalized with a
    warning.
    """
    missing = [a for a in ("n_ij", "total_corrected_residences")
               if not sn.has_attribute(a)]
    if missing:
        raise ValueError("run JumpAnalysis first (needs "
                         + ", ".join(missing) + ")")
    n_ij = np.asarray(sn.n_ij, dtype=np.float64).copy()
    t_i = np.asarray(sn.total_corrected_residences, dtype=np.float64)
    S = sn.n_sites
    if n_ij.shape != (S, S):
        raise ValueError(f"n_ij must be ({S}, {S})")
    np.fill_diagonal(n_ij, 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        P = np.where(t_i[:, None] > 0, n_ij / t_i[:, None], 0.0)
    out_mass = P.sum(axis=1)
    bad = out_mass > 1.0
    if bad.any():
        logger.warning(
            "%d site(s) have more recorded jumps than residence frames; "
            "renormalizing their rows", int(bad.sum()))
        P[bad] /= out_mass[bad, None]
        out_mass = P.sum(axis=1)
    idx = np.arange(S)
    P[idx, idx] = 1.0 - out_mass
    # never-visited sites: absorbing rows (diagonal already 1 from above)
    return P


def mean_first_passage_times(P):
    """Mean first-passage time matrix of a discrete-time Markov chain.

    ``M[i, j]`` = expected number of frames for a walker at site ``i``
    to first reach site ``j`` (``M[i, i] = 0``; the mean *recurrence*
    time is ``1/pi_i``).  Computed exactly through the fundamental
    matrix ``Z = (I - P + 1 pi)^{-1}`` (Kemeny & Snell):
    ``M[i, j] = (Z[j, j] - Z[i, j]) / pi_j``.

    States without stationary mass — unreachable absorbing states (how
    never-visited sites are encoded by
    :func:`transition_matrix_from_network`) and *transient* states
    (visited early, abandoned, never re-entered) — are excluded: their
    rows and columns are returned as ``inf``.  The remaining states
    must form ONE recurrent class (the normal case for a chain measured
    from data); a chain with several disconnected recurrent classes
    makes cross-class passage times undefined and raises
    ``LinAlgError`` from the singular fundamental-matrix solve.
    """
    P = np.asarray(P, dtype=np.float64)
    S = len(P)
    if P.shape != (S, S):
        raise ValueError("P must be square")
    if not np.allclose(P.sum(axis=1), 1.0, atol=1e-8):
        raise ValueError("transition matrix must be row-stochastic")
    pi = KineticMonteCarlo._stationary(P)
    M = np.full((S, S), np.inf)
    # relative threshold: transient states' power-iterated mass decays
    # to the convergence floor (~1e-13), not to exact zero — a bare
    # pi > 0 would keep them and divide by that floor, producing huge
    # finite garbage instead of the documented inf
    live = pi > 1e-9 * pi.max()
    if not live.any():
        return M
    idx = np.flatnonzero(live)
    Ps = P[np.ix_(idx, idx)]
    # renormalize in case tiny mass leaks to dead states
    Ps = Ps / Ps.sum(axis=1, keepdims=True)
    pis = pi[idx] / pi[idx].sum()
    n = len(idx)
    Z = np.linalg.inv(np.eye(n) - Ps + np.outer(np.ones(n), pis))
    Ms = (np.diag(Z)[None, :] - Z) / pis[None, :]
    np.fill_diagonal(Ms, 0.0)
    M[np.ix_(idx, idx)] = Ms
    return M


class KineticMonteCarlo:
    """Resample a site network's frame-resolution Markov chain.

    Parameters
    ----------
    n_walkers : independent pseudo-ions to simulate.
    n_frames : frames to generate.
    seed : PRNG seed (deterministic per seed on a given backend).
    start : ``'occupancies'`` (draw initial sites from the measured
        occupancies when present, else stationary), ``'stationary'``
        (left Perron eigenvector of the transition matrix), or an
        explicit ``(n_walkers,)`` integer array of initial sites.
    transition_matrix : optional explicit ``(S, S)`` row-stochastic
        matrix; default is derived from the network's JumpAnalysis
        attributes via :func:`transition_matrix_from_network`.

    ``run(sn)`` returns a :class:`SiteTrajectory` over a pseudo-network:
    the same host structure/static lattice and site centers/types, with
    ``n_walkers`` mobile pseudo-atoms (placed at their initial site
    centers).  Every label-based engine — ``JumpAnalysis``,
    ``SiteDiffusionAnalysis``, ``SiteFreeEnergyAnalysis``, pathway
    analysis — runs on it unchanged.  After ``run``:
    ``transition_matrix_``, ``stationary_`` (the chain's stationary
    distribution), and the returned trajectory's network carries no
    ``vertices`` (the walk never leaves the site graph).
    """

    def __init__(self, n_walkers=64, n_frames=10000, seed=0,
                 start="occupancies", transition_matrix=None,
                 verbose=True):
        self.n_walkers = int(n_walkers)
        self.n_frames = int(n_frames)
        if self.n_walkers < 1 or self.n_frames < 1:
            raise ValueError("n_walkers and n_frames must be >= 1")
        self.seed = int(seed)
        if not (isinstance(start, str) and start in ("occupancies",
                                                     "stationary")):
            start = np.asarray(start)
            if start.ndim != 1 or len(start) != self.n_walkers:
                raise ValueError("explicit start must be (n_walkers,) "
                                 "site indices")
        self.start = start
        self.transition_matrix = transition_matrix
        self.verbose = verbose

    # -- chain setup ---------------------------------------------------
    @staticmethod
    def _stationary(P):
        """Stationary distribution by power iteration.

        An eigen-decomposition is wrong for reducible chains: the
        matrices :func:`transition_matrix_from_network` builds make
        never-visited sites *absorbing* (eigenvalue 1 is degenerate) and
        ``argmin(|w-1|)`` could return all-mass-on-an-unreachable-site.
        Instead start uniform over states that are plausibly recurrent —
        excluding unreachable absorbing states (no in-flow, self-loop 1,
        which is exactly how unvisited sites are encoded) — and iterate
        ``pi @ P``; for a reducible chain with several fed recurrent
        classes this converges to the basin-weighted mixture, which is
        the physically sensible resampling default."""
        S = len(P)
        inflow = P.sum(axis=0) - np.diag(P)
        isolated = (inflow <= 0) & (np.diag(P) >= 1.0 - 1e-12)
        pi = np.where(isolated, 0.0, 1.0)
        if pi.sum() == 0:
            pi = np.ones(S)
        pi = pi / pi.sum()
        # lazy chain (P+I)/2: same stationary distribution, provably
        # aperiodic, so the iteration converges even for cyclic P
        for _ in range(20000):
            nxt = 0.5 * (pi + pi @ P)
            nxt = nxt / nxt.sum()
            if np.abs(nxt - pi).max() < 1e-13:
                return nxt
            pi = nxt
        # convergence rate is ~|lambda_2|^n: chains with relaxation
        # timescales beyond ~2e4 frames land here still biased toward
        # the uniform start — never let that pass silently (posterior
        # resampling uses an exact solve instead; see
        # dynamics/uncertainty._obs_stationary)
        logger.warning(
            "stationary power iteration unconverged after 20000 "
            "iterations (slowest relaxation beyond ~2e4 frames); "
            "the returned distribution is approximate")
        return pi

    def _initial_sites(self, sn, P, rng):
        if not isinstance(self.start, str):
            start = np.asarray(self.start, dtype=np.int64)
            if (start < 0).any() or (start >= sn.n_sites).any():
                raise ValueError("start sites out of range")
            return start
        if self.start == "occupancies" and sn.has_attribute("occupancies"):
            p = np.asarray(sn.occupancies, dtype=np.float64)
            p = np.where(p > 0, p, 0.0)
        else:
            p = self._stationary(P)
        if p.sum() <= 0:
            p = np.ones(sn.n_sites)
        p = p / p.sum()
        return rng.choice(sn.n_sites, size=self.n_walkers, p=p)

    # -- the walk (device) ----------------------------------------------
    @staticmethod
    def _walk(P, s0, n_frames, seed):
        """(F, W) int32 labels: Gumbel-max categorical scan on device."""
        import jax
        import jax.numpy as jnp

        logP = jnp.where(P > 0, jnp.log(jnp.maximum(P, 1e-300)),
                         -jnp.inf).astype(jnp.float32)

        def step(carry, key):
            s = carry
            g = jax.random.gumbel(key, (s.shape[0], logP.shape[1]),
                                  dtype=jnp.float32)
            nxt = jnp.argmax(logP[s] + g, axis=1).astype(jnp.int32)
            return nxt, s

        keys = jax.random.split(jax.random.PRNGKey(seed), n_frames - 1)
        s0 = jnp.asarray(s0, dtype=jnp.int32)
        last, labels = jax.lax.scan(step, s0, keys)
        labels = jnp.concatenate([labels, last[None]], axis=0)
        return np.asarray(jax.device_get(labels))

    # -- pseudo-network --------------------------------------------------
    @staticmethod
    def _pseudo_network(sn, init_sites, n_walkers):
        host = sn.structure
        static_idx = np.flatnonzero(sn.static_mask)
        mobile_species = (host.species[sn.mobile_mask][0]
                          if sn.n_mobile else 0)
        pos = np.concatenate([host.positions[static_idx],
                              np.asarray(sn.centers)[init_sites]], axis=0)
        species = np.concatenate([host.species[static_idx],
                                  np.full(n_walkers, mobile_species,
                                          dtype=np.int32)])
        structure = Structure(pos, species, host.cell, pbc=host.pbc)
        n_static = len(static_idx)
        static_mask = np.zeros(n_static + n_walkers, dtype=bool)
        static_mask[:n_static] = True
        out = SiteNetwork(structure, static_mask, ~static_mask)
        out.centers = np.asarray(sn.centers).copy()
        if sn.site_types is not None:
            out.site_types = sn.site_types.copy()
        return out

    def run(self, sn):
        if sn.n_sites < 1:
            raise ValueError("site network has no sites")
        P = (transition_matrix_from_network(sn)
             if self.transition_matrix is None
             else np.asarray(self.transition_matrix, dtype=np.float64))
        if P.shape != (sn.n_sites, sn.n_sites):
            raise ValueError("transition matrix must be "
                             f"({sn.n_sites}, {sn.n_sites})")
        rowsum = P.sum(axis=1)
        if not np.allclose(rowsum, 1.0, atol=1e-8) or (P < -1e-12).any():
            raise ValueError("transition matrix must be row-stochastic")
        rng = np.random.default_rng(self.seed)
        s0 = self._initial_sites(sn, P, rng)
        labels = self._walk(P, s0, self.n_frames, self.seed)
        self.transition_matrix_ = P
        self.stationary_ = self._stationary(P)
        out_sn = self._pseudo_network(sn, s0, self.n_walkers)
        st = SiteTrajectory(out_sn, labels)
        if self.verbose:
            n_hops = int((labels[1:] != labels[:-1]).sum())
            logger.info(
                "KMC: %d walkers x %d frames on %d sites, %d hops "
                "(%.4g per walker-frame)", self.n_walkers, self.n_frames,
                sn.n_sites, n_hops,
                n_hops / (self.n_walkers * max(1, self.n_frames - 1)))
        return st
