"""Native JAX SOAP-style descriptors (power spectrum of a local density
expansion) — accelerator-friendly dense einsums.

Replaces the reference's external quippy/GAP (Fortran) and dscribe (C++)
SOAP backends (``sitator/site_descriptors/SOAP.py``, SURVEY.md §3.6, §3.9
item 4), neither of which exists in this environment.  The expansion here
evaluates a Gaussian radial basis × real spherical harmonics at neighbor
positions (smooth-cutoff weighted) and forms the rotation-invariant power
spectrum

    p^{αβ}_{n n' l} = Σ_m c^α_{nlm} c^β_{n'lm},

per species pair — the same invariance structure as GAP SOAP.

**Radial basis.**  Two orthonormalized radial bases are provided, selected
by ``radial_basis``:

- ``'gauss'`` (default): Gaussians on an equispaced grid in ``[0, r_cut]``,
  orthonormalized by the inverse square root of their overlap matrix
  ``S_{nn'} = ∫ φ_n φ_{n'} r² dr`` — the same Löwdin treatment dscribe
  applies to its GTO primitives, so coefficients are true projections onto
  an orthonormal set rather than raw samples of overlapping Gaussians;
- ``'poly'``: the dscribe-style polynomial basis ``φ_n(r) ∝ (r_cut − r)^{n+2}``,
  likewise Löwdin-orthonormalized.

**Density model** (``density=``):

- ``'delta'`` (default, the pre-0.4 behavior): the neighbor density is a
  delta density evaluated at atom positions — radial smearing folded into
  the basis width, angular smearing absent.  Fast and adequate for
  within-backend site typing, but absolute values differ from
  quippy/dscribe.
- ``'gauss'``: GAP-fidelity atom-centered Gaussian smearing.  The exact
  expansion of a Gaussian at distance ``R`` along ``r̂_j`` is

      c_nlm = 4π Y_lm(r̂_j) ∫ u_n(r) r² e^{-(r²+R²)/2σ²} i_l(rR/σ²) dr,

  with ``i_l`` the modified spherical Bessel function — the same
  analytic route dscribe/quippy take.  Device-first execution: the radial
  integrals ``I_nl(R)`` are quadratured host-side in float64 ONCE per
  configuration (exp-scaled Bessels, no overflow at any σ) onto a dense
  ``R`` table; the device kernel linearly interpolates the table per
  neighbor and runs the same dense einsums as the delta path — no extra
  HLO beyond a ``(G, n·l)`` gather.  Validated against direct 3D
  quadrature of the smeared density (``tests/test_network_descriptors``).

``'delta'`` stays the production default because the *decisions* match:
on the FCC tet/oct system both densities produce the identical
``SiteTypeAnalysis`` partition, through ideal centers
(``tests/test_fcc.py::test_fcc_typing_gauss_density_agrees_with_delta``)
AND through trajectory-sampled ``SOAPDescriptorAverages``
(``test_fcc_default_delta_types_like_gauss_on_sampled_trajectory``) —
so the fast path is the right default; choose ``'gauss'`` when absolute
descriptor values must match GAP/dscribe conventions.

The descriptor interface is pluggable (SURVEY.md §3.9), so an external
SOAP can be swapped in where available.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sitator_tpu.ops.pbc import min_image_disp

__all__ = ["soap_descriptors", "soap_descriptors_env",
           "radial_orthonormalizer", "radial_smearing_table",
           "SOAPDescriptorAverages", "SiteCentersDescriptor"]


def _real_sph_harm(unit_vecs, l_max):
    """Real spherical harmonics Y_lm at unit vectors (..., 3) for
    l = 0..l_max.  Returns (..., (l_max+1)^2) ordered [(l, m)] with
    m = -l..l (sin components for m<0, cos for m>0)."""
    x, y, z = unit_vecs[..., 0], unit_vecs[..., 1], unit_vecs[..., 2]
    ct = jnp.clip(z, -1.0, 1.0)                       # cos(theta)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))    # sin(theta)
    phi = jnp.arctan2(y, x)

    # associated Legendre P_l^m(ct) via stable recurrences
    P = {}
    P[(0, 0)] = jnp.ones_like(ct)
    for m in range(1, l_max + 1):
        P[(m, m)] = (2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    feats = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                             * math.factorial(l - am)
                             / math.factorial(l + am))
            if m == 0:
                feats.append(norm * P[(l, 0)])
            elif m > 0:
                feats.append(math.sqrt(2) * norm * P[(l, m)]
                             * jnp.cos(m * phi))
            else:
                feats.append(math.sqrt(2) * norm * P[(l, am)]
                             * jnp.sin(am * phi))
    return jnp.stack(feats, axis=-1)


def radial_orthonormalizer(r_cut, sigma, n_max, radial_basis="gauss",
                           n_quad=2048, drop_tol=1e-7):
    """Canonical orthogonalization ``W`` of the radial basis:
    ``u = φ @ W`` satisfies ``∫ u_n u_{n'} r² dr = δ_{nn'}`` on the kept
    channels.

    ``S_{nn'} = ∫_0^{r_cut} φ_n φ_{n'} r² dr`` by quadrature (host-side,
    once per configuration).  Primitives are norm-scaled first, then
    eigen-directions of the normalized overlap below ``drop_tol · λ_max``
    are DROPPED (their columns of ``W`` zeroed) — the quantum-chemistry
    canonical-orthogonalization treatment for near-linearly-dependent
    bases, which the dscribe-style polynomial primitives are (their raw
    overlap spans ~15 decades at n_max=8; symmetric Löwdin would either
    blow up in f32 or silently de-orthonormalize under eigenvalue
    clamping).  Dropped channels carry no independent radial information;
    the descriptor layout keeps its static shape.  Projecting a delta
    density onto the orthonormal set is exactly ``c_raw @ W``.
    """
    r = np.linspace(0.0, r_cut, n_quad)
    phi = _radial_raw_np(r, r_cut, sigma, n_max, radial_basis)  # (Q, n)
    S = np.trapezoid(phi[:, :, None] * phi[:, None, :]
                     * (r ** 2)[:, None, None], r, axis=0)
    norms = np.sqrt(np.diag(S))
    Sn = S / norms[:, None] / norms[None, :]
    lam, V = np.linalg.eigh(Sn)
    keep = lam > drop_tol * lam.max()
    W = np.zeros((n_max, n_max))
    W[:, keep] = (V[:, keep] / np.sqrt(lam[keep])) / norms[:, None]
    return W


def _radial_raw_np(r, r_cut, sigma, n_max, radial_basis):
    """Raw (pre-orthonormalization) radial basis, NumPy: (len(r), n_max)."""
    r = np.asarray(r, np.float64)
    if radial_basis == "gauss":
        centers = np.linspace(0.0, r_cut, n_max)
        return np.exp(-((r[:, None] - centers[None, :]) ** 2)
                      / (2.0 * sigma ** 2))
    if radial_basis == "poly":
        # dscribe's polynomial basis: (r_cut - r)^(n+2), zero-valued and
        # zero-sloped at the cutoff for every n
        powers = np.arange(n_max) + 2
        return np.where(r[:, None] < r_cut,
                        (r_cut - np.minimum(r, r_cut))[:, None] ** powers,
                        0.0)
    raise ValueError("radial_basis must be 'gauss' or 'poly'")


def radial_smearing_table(r_cut, sigma, n_max, l_max, radial_basis="gauss",
                          W=None, n_grid=512, n_quad=2048):
    """Analytic radial integrals for the Gaussian-smeared density,
    tabulated on a uniform neighbor-distance grid.

    ``I_nl(R) = 4π ∫_0^{r_cut} u_n(r) r² e^{-(r²+R²)/2σ²} i_l(rR/σ²) dr``
    where ``u = φ @ W`` is the orthonormal radial basis and ``i_l`` the
    modified spherical Bessel function of the first kind.  Computed with
    exp-scaled Bessels (``e^{-x} i_l(x)``) so the integrand is
    ``u_n(r) r² e^{-(r-R)²/2σ²} [e^{-x} i_l(x)]`` — overflow-free at any
    σ.  Returns ``(table, dR)`` with ``table`` of shape
    ``(n_grid, n_max, l_max+1)`` float64 over ``R ∈ [0, r_cut]``.
    """
    from scipy.special import ive

    if W is None:
        W = radial_orthonormalizer(r_cut, sigma, n_max, radial_basis)
    r = np.linspace(0.0, r_cut, n_quad)
    u = _radial_raw_np(r, r_cut, sigma, n_max, radial_basis) @ W  # (Q, n)
    R = np.linspace(0.0, r_cut, n_grid)
    x = np.maximum(r[:, None] * R[None, :] / (sigma ** 2), 0.0)   # (Q, G)
    gauss = np.exp(-((r[:, None] - R[None, :]) ** 2)
                   / (2.0 * sigma ** 2))                          # (Q, G)
    table = np.empty((n_grid, n_max, l_max + 1))
    dblfact = 1.0
    for l in range(l_max + 1):
        if l > 0:
            dblfact *= (2 * l + 1)
        # e^{-x} i_l(x); series limit x^l/(2l+1)!! below quadrature noise
        with np.errstate(invalid="ignore", divide="ignore"):
            il = np.sqrt(np.pi / (2.0 * np.maximum(x, 1e-300))) \
                * ive(l + 0.5, x)
        small = x < 1e-6
        il = np.where(small, (x ** l) / dblfact * np.exp(-x), il)
        kern = 4.0 * np.pi * gauss * il * (r ** 2)[:, None]       # (Q, G)
        # (Q, G) x (Q, n) -> (G, n)
        table[:, :, l] = np.trapezoid(kern[:, :, None] * u[:, None, :],
                                      r, axis=0).reshape(n_grid, n_max)
    return table, R[1] - R[0]


def _radial_raw(r, r_cut, sigma, n_max, radial_basis):
    """Raw radial basis, jnp (traced in-kernel): (N, n_max)."""
    if radial_basis == "gauss":
        centers = jnp.linspace(0.0, r_cut, n_max)
        return jnp.exp(-((r[:, None] - centers[None, :]) ** 2)
                       / (2.0 * sigma ** 2))
    powers = jnp.arange(n_max) + 2
    base = jnp.maximum(r_cut - r, 0.0)
    return base[:, None] ** powers[None, :]


@partial(jax.jit, static_argnames=("n_max", "l_max", "n_species",
                                   "radial_basis"))
def _soap_one(probe, positions, species_onehot, cell, cell_inv, r_cut,
              sigma, n_max, l_max, n_species, W=None,
              radial_basis="gauss", smear_table=None):
    """SOAP vector for one probe.  positions (N, 3); species_onehot
    (N, n_species) with zero rows for atoms to ignore; ``W`` the radial
    orthonormalizer from :func:`radial_orthonormalizer` (None = raw
    basis, the pre-0.3 behavior).  ``smear_table``: the
    :func:`radial_smearing_table` array ``(G, n_max, l_max+1)`` —
    switches the density model from delta to Gaussian-smeared (the
    table's R grid spans ``[0, r_cut]``)."""
    disp = min_image_disp(positions - probe, cell, cell_inv)   # (N, 3)
    r = jnp.sqrt(jnp.sum(disp * disp, axis=-1))
    safe_r = jnp.maximum(r, 1e-9)
    unit = disp / safe_r[:, None]

    # smooth cosine cutoff; excludes atoms beyond r_cut
    fcut = jnp.where(r < r_cut, 0.5 * (jnp.cos(jnp.pi * r / r_cut) + 1.0),
                     0.0)                                      # (N,)
    Y = _real_sph_harm(unit, l_max)                            # (N, L2)
    w = species_onehot * fcut[:, None]                         # (N, S)

    if smear_table is not None:
        # per-neighbor radial integrals by linear interpolation of the
        # host-precomputed table: (N,) -> (N, n_max, l_max+1)
        G = smear_table.shape[0]
        t = jnp.clip(r / r_cut * (G - 1), 0.0, G - 1)
        i0 = jnp.clip(t.astype(jnp.int32), 0, G - 2)
        f = (t - i0)[:, None, None]
        tab = smear_table.astype(jnp.float32)
        gl = jnp.take(tab, i0, axis=0) * (1.0 - f) \
            + jnp.take(tab, i0 + 1, axis=0) * f      # (N, n, l_max+1)
        # expand l -> lm and contract in one dense einsum
        l_of_lm = np.repeat(np.arange(l_max + 1),
                            [2 * l + 1 for l in range(l_max + 1)])
        glm = gl[:, :, jnp.asarray(l_of_lm)]                   # (N, n, L2)
        c = jnp.einsum("js,jnl,jl->snl", w, glm, Y,
                      precision=jax.lax.Precision.HIGHEST)
    else:
        g = _radial_raw(r, r_cut, sigma, n_max, radial_basis)  # (N, n_max)
        if W is not None:
            g = g @ W             # project onto the ORTHONORMAL basis
        # c[s, n, lm] = sum_j onehot[j, s] fcut[j] g[j, n] Y[j, lm]
        c = jnp.einsum("js,jn,jl->snl", w, g, Y,
                      precision=jax.lax.Precision.HIGHEST)

    # power spectrum per (s, s', n, n', l): sum over m
    l_sizes = [2 * l + 1 for l in range(l_max + 1)]
    out = []
    lo = 0
    for l, sz in enumerate(l_sizes):
        cl = c[:, :, lo:lo + sz]                               # (S, n, m)
        pl = jnp.einsum("snm,tpm->stnp", cl, cl,
                        precision=jax.lax.Precision.HIGHEST) / math.sqrt(sz)
        out.append(pl.reshape(n_species * n_species * n_max * n_max))
        lo += sz
    p = jnp.concatenate(out)
    norm = jnp.sqrt(jnp.sum(p * p))
    return p / jnp.maximum(norm, 1e-12)


def soap_descriptors(probes, positions, species, cell, r_cut=5.0,
                     sigma=0.5, n_max=8, l_max=6, species_list=None,
                     batch=256, radial_basis="gauss", density="delta"):
    """SOAP vectors for ``probes (P, 3)`` in the environment of
    ``positions (N, 3)`` with ``species (N,)``.  Returns (P, D) float32.
    ``density``: 'delta' or 'gauss' (GAP-fidelity atom-centered Gaussian
    smearing of width ``sigma`` — see module docstring).
    """
    positions = np.asarray(positions, dtype=np.float32)
    species = np.asarray(species)
    if species_list is None:
        species_list = np.unique(species)
    n_species = len(species_list)
    onehot = np.zeros((len(positions), n_species), dtype=np.float32)
    for i, s in enumerate(species_list):
        onehot[species == s, i] = 1.0
    cell = np.asarray(cell, dtype=np.float32)
    cell_inv = np.linalg.inv(cell).astype(np.float32)
    Wnp = radial_orthonormalizer(r_cut, sigma, n_max, radial_basis)
    smear = None
    if density == "gauss":
        smear = jnp.asarray(radial_smearing_table(
            r_cut, sigma, n_max, l_max, radial_basis, W=Wnp)[0])
    elif density != "delta":
        raise ValueError("density must be 'delta' or 'gauss'")
    W = jnp.asarray(Wnp)

    fn = jax.vmap(partial(_soap_one, W=W, radial_basis=radial_basis,
                          smear_table=smear),
                  in_axes=(0,) + (None,) * 8 + (None,))
    outs = []
    probes = np.asarray(probes, dtype=np.float32)
    for lo in range(0, len(probes), batch):
        blk = jnp.asarray(probes[lo:lo + batch])
        outs.append(np.asarray(fn(
            blk, jnp.asarray(positions), jnp.asarray(onehot),
            jnp.asarray(cell), jnp.asarray(cell_inv), r_cut, sigma,
            n_max, l_max, n_species)))
    return np.concatenate(outs, axis=0)


def _species_onehot(species, species_list):
    onehot = np.zeros((len(species), len(species_list)), dtype=np.float32)
    for i, s in enumerate(species_list):
        onehot[np.asarray(species) == s, i] = 1.0
    return onehot


def soap_descriptors_env(probes, envs, species, cell, r_cut=5.0,
                         sigma=0.5, n_max=8, l_max=6, species_list=None,
                         batch=64, radial_basis="gauss", W=None,
                         density="delta", smear_table=None):
    """SOAP vectors for ``probes (P, 3)``, each in its OWN environment
    ``envs (P, N, 3)`` (e.g. per-frame static lattices) with shared
    ``species (N,)``.  One vmapped device dispatch per ``batch`` probes —
    the sampling path of :class:`SOAPDescriptorAverages`.  ``W`` /
    ``smear_table``: optional precomputed :func:`radial_orthonormalizer` /
    :func:`radial_smearing_table` (hoist them when calling in a loop)."""
    envs = np.asarray(envs, dtype=np.float32)
    if species_list is None:
        species_list = np.unique(species)
    onehot = jnp.asarray(_species_onehot(species, species_list))
    cell = np.asarray(cell, dtype=np.float32)
    cell_inv = np.linalg.inv(cell).astype(np.float32)
    if W is None:
        W = radial_orthonormalizer(r_cut, sigma, n_max, radial_basis)
    smear = None
    if density == "gauss":
        smear = jnp.asarray(
            smear_table if smear_table is not None
            else radial_smearing_table(r_cut, sigma, n_max, l_max,
                                       radial_basis, W=W)[0])
    elif density != "delta":
        raise ValueError("density must be 'delta' or 'gauss'")
    W = jnp.asarray(W)

    fn = jax.vmap(partial(_soap_one, W=W, radial_basis=radial_basis,
                          smear_table=smear),
                  in_axes=(0, 0) + (None,) * 7 + (None,))
    outs = []
    probes = np.asarray(probes, dtype=np.float32)
    for lo in range(0, len(probes), batch):
        outs.append(np.asarray(fn(
            jnp.asarray(probes[lo:lo + batch]),
            jnp.asarray(envs[lo:lo + batch]), onehot,
            jnp.asarray(cell), jnp.asarray(cell_inv), r_cut, sigma,
            n_max, l_max, len(species_list))))
    return np.concatenate(outs, axis=0)


class SOAPDescriptorAverages:
    """Per-site SOAP by averaging descriptors of sampled assigned positions
    (reference ``SOAPDescriptorAverages`` parity): probes are real mobile-ion
    positions while assigned to the site, each evaluated in its own frame's
    static-lattice environment, then averaged per site.

    ``get_descriptors(st)`` → ((n_sites, D), counts).
    """

    def __init__(self, r_cut=5.0, sigma=0.5, n_max=8, l_max=6,
                 averages_n=16, seed=0, radial_basis="gauss",
                 density="delta", verbose=True):
        self.r_cut = float(r_cut)
        self.sigma = float(sigma)
        self.n_max = int(n_max)
        self.l_max = int(l_max)
        self.averages_n = int(averages_n)
        self.seed = seed
        self.radial_basis = radial_basis
        self.density = density
        self.verbose = verbose

    def get_descriptors(self, st):
        sn = st.site_network
        if st.real_trajectory is None:
            raise ValueError("SiteTrajectory needs a real trajectory")
        rng = np.random.default_rng(self.seed)
        static_idx = np.flatnonzero(sn.static_mask)
        mobile_idx = np.flatnonzero(sn.mobile_mask)
        species = sn.structure.species[static_idx]
        species_list = np.unique(species)
        cell = sn.structure.cell

        # one pass over the assignment matrix: group samples by site, then
        # draw up to averages_n per site
        fr_all, io_all = np.nonzero(st.traj >= 0)
        lab_all = st.traj[fr_all, io_all]
        sel_f, sel_i, sel_s = [], [], []
        counts = np.zeros(sn.n_sites, dtype=np.int64)
        order = np.argsort(lab_all, kind="stable")
        bounds = np.searchsorted(lab_all[order], np.arange(sn.n_sites + 1))
        for site in range(sn.n_sites):
            grp = order[bounds[site]:bounds[site + 1]]
            if len(grp) == 0:
                continue
            if len(grp) > self.averages_n:
                grp = grp[rng.choice(len(grp), self.averages_n,
                                     replace=False)]
            # convention (unchanged from round 1): counts = number of
            # samples actually averaged, capped at averages_n
            counts[site] = len(grp)
            sel_f.append(fr_all[grp])
            sel_i.append(io_all[grp])
            sel_s.append(np.full(len(grp), site, dtype=np.int64))
        if not sel_f:
            raise ValueError("SiteTrajectory has no assigned samples")
        sel_f = np.concatenate(sel_f)
        sel_i = np.concatenate(sel_i)
        sel_s = np.concatenate(sel_s)

        # every probe is a real ion position evaluated in ITS OWN frame's
        # static environment — batched into vmapped device dispatches;
        # environments are gathered chunkwise (T·N·3 all at once can be GBs)
        probes = st.real_trajectory[sel_f, mobile_idx[sel_i]]
        chunk = 512
        d_parts = []
        W = radial_orthonormalizer(self.r_cut, self.sigma, self.n_max,
                                   self.radial_basis)
        smear = (radial_smearing_table(self.r_cut, self.sigma, self.n_max,
                                       self.l_max, self.radial_basis,
                                       W=W)[0]
                 if self.density == "gauss" else None)
        for lo in range(0, len(sel_f), chunk):
            f_c = sel_f[lo:lo + chunk]
            envs = st.real_trajectory[f_c][:, static_idx]
            d_parts.append(soap_descriptors_env(
                probes[lo:lo + chunk], envs, species, cell,
                r_cut=self.r_cut, sigma=self.sigma, n_max=self.n_max,
                l_max=self.l_max, species_list=species_list,
                radial_basis=self.radial_basis, W=W,
                density=self.density, smear_table=smear))
        d_all = np.concatenate(d_parts, axis=0)

        D = d_all.shape[1]
        out = np.zeros((sn.n_sites, D), dtype=np.float64)
        np.add.at(out, sel_s, d_all.astype(np.float64))
        n_sel = np.bincount(sel_s, minlength=sn.n_sites)
        occupied = n_sel > 0
        out[occupied] /= n_sel[occupied, None]
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        out = np.where(norms > 1e-12, out / np.maximum(norms, 1e-12), out)
        return out.astype(np.float32), counts


class SiteCentersDescriptor:
    """Per-center SOAP variant (reference's per-center descriptor ⚠):
    probes at the site centers, environment = the static reference
    structure."""

    def __init__(self, r_cut=5.0, sigma=0.5, n_max=8, l_max=6,
                 radial_basis="gauss", density="delta"):
        self.r_cut = float(r_cut)
        self.sigma = float(sigma)
        self.n_max = int(n_max)
        self.l_max = int(l_max)
        self.radial_basis = radial_basis
        self.density = density

    def get_descriptors(self, st_or_sn):
        sn = getattr(st_or_sn, "site_network", st_or_sn)
        static = sn.static_structure
        d = soap_descriptors(sn.centers, static.positions, static.species,
                             sn.structure.cell, r_cut=self.r_cut,
                             sigma=self.sigma, n_max=self.n_max,
                             l_max=self.l_max,
                             radial_basis=self.radial_basis,
                             density=self.density)
        return d, np.full(sn.n_sites, 1)
