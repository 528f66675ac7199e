"""Command-line interface: ``python -m sitator_tpu <command> ...``.

Production entry points over the library (no Python required):

- ``info TRAJ``      — sniff the format, print frames/atoms/cell/species.
- ``convert SRC OUT``— stream-convert any readable trajectory to
  ``.npy`` (memmap) or a zarr store (by OUT extension), O(1) memory.
- ``analyze TRAJ``   — the canonical pipeline (SURVEY.md §4.1):
  Voronoi seeding → landmark analysis → optional merging/debounce →
  jump statistics → optional diffusivity (+ ``--diagnose`` health
  checks), saved as ``.npz`` results; ``--streaming`` runs the
  out-of-core engine and post-processes from the spilled label file.
- ``arrhenius T=PATH [T=PATH ...]`` — the temperature-series workflow:
  one full analysis per file, cross-temperature site matching, scalar
  tracer-D Arrhenius and per-jump-pathway ``Ea_ij``.
- ``sites STRUCTURE`` — trajectory-free site screening from a structure
  file (xyz / POSCAR / CIF): Voronoi geometry or bond-valence
  chemistry, with ``--supercell`` tiling.
- ``doctor`` — environment/accelerator report (backend, devices, probe
  matmul).

Beyond-reference convenience: upstream ``sitator`` is library-only.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

__all__ = ["main"]

logger = logging.getLogger("sitator_tpu.cli")


def _species_arg(s):
    """Atomic number or chemical symbol → atomic number."""
    from sitator_tpu.core.structure import symbol_to_number
    try:
        return int(s)
    except ValueError:
        return symbol_to_number(s)


def _structure_file_hint(path):
    return SystemExit(
        f"{path} is a single-structure file, not a trajectory — use "
        "`sitator_tpu sites` to screen candidate sites from it, or "
        "pass it as --structure alongside a trajectory")


def _open(path, variable_cell=None):
    from sitator_tpu.io import open_trajectory
    from sitator_tpu.io.formats import sniff_format, structure_format

    sf = structure_format(path)
    kwargs = {}
    if variable_cell:
        kwargs["variable_cell"] = variable_cell
    try:
        reader = open_trajectory(path, **kwargs)
    except ValueError as e:
        # keep REAL trajectory errors (e.g. the variable-cell rescale
        # hint) intact: only claim "structure file" when the file
        # actually PARSES as one (a Cartesian POSCAR sniffs as
        # XDATCAR and fails mid-parse; a real NPT XDATCAR with a
        # CONTCAR-ish name must keep its actionable message)
        if sf == "cif":                  # .cif is never a trajectory
            raise _structure_file_hint(path)
        if sf == "poscar":
            from sitator_tpu.io.formats import read_structure
            try:
                read_structure(path)
            except Exception:
                pass
            else:
                raise _structure_file_hint(path)
        raise SystemExit(str(e))
    # a Direct-coordinates POSCAR parses as a 1-frame XDATCAR and would
    # silently run a meaningless single-frame analysis — catch it
    # proactively (structure_format never claims 'poscar' for names
    # that declare themselves trajectories, e.g. *.xdatcar)
    if sf == "poscar" and len(reader) == 1:
        raise _structure_file_hint(path)
    return reader


def _load_structure(args, reader):
    """Structure from the trajectory file itself or --structure."""
    if getattr(args, "structure", None):
        from sitator_tpu.io.formats import read_structure
        return read_structure(args.structure)   # xyz / POSCAR / CIF
    structure = getattr(reader, "structure", None)
    if structure is None:
        raise SystemExit(
            "this trajectory format carries no structure; pass "
            "--structure FIRST_FRAME.xyz (species + cell)")
    return structure


def _print_cell_species(structure):
    from sitator_tpu.core.structure import number_to_symbol
    np.set_printoptions(precision=4, suppress=True)
    print(f"cell:\n{structure.cell}")
    zs, counts = np.unique(structure.species, return_counts=True)
    print("species: " + " ".join(
        f"{number_to_symbol(int(z))}{c}" for z, c in zip(zs, counts)))


def cmd_info(args):
    from sitator_tpu.io.formats import (read_structure, sniff_format,
                                        structure_format)
    kind = structure_format(args.traj)
    if kind in ("poscar", "cif"):
        s = read_structure(args.traj)
        print(f"format:  {kind} (single structure)")
        print(f"atoms:   {s.n_atoms}")
        _print_cell_species(s)
        return 0
    fmt = sniff_format(args.traj)
    reader = _open(args.traj, args.variable_cell)
    print(f"format:  {fmt}")
    print(f"frames:  {len(reader)}")
    print(f"atoms:   {reader.n_atoms}")
    structure = getattr(reader, "structure", None)
    if structure is not None:
        _print_cell_species(structure)
    return 0


def cmd_convert(args):
    out = args.out
    kw = {}
    if args.variable_cell:
        kw["variable_cell"] = args.variable_cell
    # --zarr/--zarr3 force a zarr store even for a .npy-suffixed OUT
    if args.zarr or args.zarr3 or out.endswith(".zarr"):
        from sitator_tpu.io import convert_to_zarr
        convert_to_zarr(args.traj, out,
                        zarr_format=3 if args.zarr3 else 2, **kw)
    elif out.endswith(".npy"):
        from sitator_tpu.io import convert_to_npy
        from sitator_tpu.io.formats import structure_sidecar_path
        structure, _ = convert_to_npy(args.traj, out, **kw)
        if structure is not None:
            print(f"structure sidecar: {structure_sidecar_path(out)}")
    else:
        raise SystemExit("OUT must end in .npy or .zarr")
    print(f"wrote {out}")
    return 0


def _seed_network(args, traj_path):
    """Open + structure + masks + Voronoi seeding; shared by analyze
    and arrhenius.  Returns ``(reader, seeded SiteNetwork)``."""
    from sitator_tpu import SiteNetwork
    from sitator_tpu.voronoi import VoronoiSiteGenerator

    reader = _open(traj_path, args.variable_cell)
    structure = _load_structure(args, reader)
    mobile = np.isin(structure.species, args.mobile)
    if not mobile.any():
        raise SystemExit(f"no atoms of mobile species {args.mobile}")
    static = ~mobile
    print(f"{len(reader)} frames, {int(mobile.sum())} mobile / "
          f"{int(static.sum())} static atoms")
    sn = SiteNetwork(structure, static, mobile)
    if args.sites == "density":
        from sitator_tpu.network import DensitySiteGenerator
        # strided whole-run subsample, swept out-of-core off the reader
        # (a bounded PREFIX would both materialize frames and miss
        # sites first visited late in a long run)
        stride = max(1, len(reader) // max(1, args.density_frames))
        sn = DensitySiteGenerator(stride=stride,
                                  verbose=args.verbose).run(sn, reader)
        n = len(range(0, len(reader), stride))
        print(f"landmark basis: {sn.n_sites} density sites "
              f"(sampled {n}/{len(reader)} frames)")
    elif args.sites == "bv":
        from sitator_tpu.network import BondValenceSiteGenerator
        try:
            sn = BondValenceSiteGenerator(
                v_ideal=args.bv_valence,
                mismatch_tol=args.bv_mismatch_tol,
                verbose=args.verbose).run(sn)
        except ValueError as e:
            raise SystemExit(f"--sites bv: {e}")
        print(f"landmark basis: {sn.n_sites} bond-valence sites "
              f"(|V-{args.bv_valence:g}| < {args.bv_mismatch_tol:g})")
    else:
        sn = VoronoiSiteGenerator(merge_tol=args.voronoi_merge_tol).run(sn)
        print(f"landmark basis: {sn.n_sites} Voronoi sites")
    return reader, sn


def _print_residence_diagnose(args, st, pre_debounce=False):
    """Memorylessness check.  Runs on PRE-debounce labels: the debounce
    filter removes short residences by construction, which would make
    every site reject the geometric model for the filter's reason
    rather than a physical one."""
    from sitator_tpu.dynamics import ResidenceTimeAnalysis
    ra = ResidenceTimeAnalysis(verbose=args.verbose).run(st)
    tested = int(np.isfinite(ra.p_value_).sum())
    flagged = ra.non_exponential_sites_
    note = ""
    if flagged.size:
        note = (f" (sites {flagged.tolist()} — likely over-merged; "
                "consider lower merge thresholds)")
        if pre_debounce:
            # debouncing may empty a site and renumber afterwards
            note = note[:-1] + "; indices refer to the pre-debounce " \
                               "network)"
    print(f"diagnose: {tested} sites tested for memoryless "
          f"residences; {flagged.size} flagged" + note)


def _postprocess(args, st, objs=None):
    """Shared label-based tail of both routes: optional merge →
    drop unoccupied → --diagnose (in the surviving index space) →
    optional debounce (then re-drop newly emptied sites) →
    JumpAnalysis.  Returns the final SiteTrajectory."""
    from sitator_tpu.dynamics import (
        JumpAnalysis, MergeSitesByDynamics, RemoveShortJumps,
        RemoveUnoccupiedSites)

    debounce = getattr(args, "debounce", None)
    keep = getattr(args, "keep_unoccupied", False)
    if getattr(args, "merge_dynamics", None) is not None:
        st = MergeSitesByDynamics(
            distance_threshold=args.merge_dynamics).run(st)
    if getattr(args, "merge_metastable", None) is not None:
        from sitator_tpu.dynamics import MergeSitesByMetastability
        spec = args.merge_metastable
        n_basins = "auto" if spec == "auto" else int(spec)
        ms = MergeSitesByMetastability(n_basins=n_basins,
                                       verbose=args.verbose)
        st = ms.run(st)
        sep = (f", timescale separation {ms.separation_:.1f}x"
               if np.isfinite(ms.separation_) else "")
        print(f"metastable merge: {ms.n_basins_} basins diagnosed "
              f"(mean self-transition {ms.metastability_:.3f}{sep}) "
              f"→ {st.site_network.n_sites} sites")
    if not keep:
        st = RemoveUnoccupiedSites().run(st)
    ma = None
    if getattr(args, "diagnose", False):
        _print_residence_diagnose(args, st,
                                  pre_debounce=debounce is not None)
        # markovianity likewise runs on PRE-debounce labels: debouncing
        # imposes a minimum-residence floor, so implied timescales climb
        # at lags below the threshold and CK fails at the base lag for
        # the filter's reason, not a physical one
        from sitator_tpu.dynamics import MarkovianityAnalysis
        ma = MarkovianityAnalysis(verbose=args.verbose).run(st)
    if debounce is not None:
        st = RemoveShortJumps(frame_threshold=debounce).run(st)
        if not keep:
            # debouncing can empty a rarely-visited site
            st = RemoveUnoccupiedSites().run(st)
    ja = JumpAnalysis(verbose=args.verbose)
    ja.run(st)
    print(f"final: {st.site_network.n_sites} sites, {ja.n_jumps} jumps")
    from sitator_tpu.network import DiffusionPathwayAnalysis
    dpa = DiffusionPathwayAnalysis(minimum_n_sites=2, verbose=False)
    dpa.run(st)
    if dpa.n_pathways:
        dims = dpa.pathway_dims
        print(f"pathways: {dpa.n_pathways} "
              f"({int(dpa.pathway_percolating.sum())} percolating; "
              f"max dimensionality {int(dims.max()) if len(dims) else 0}D)")
    else:
        print("pathways: none (no connected jumps)")
    if getattr(args, "bottlenecks", False):
        _print_bottlenecks(args, st)
    if getattr(args, "diagnose", False):
        from sitator_tpu.dynamics import (DetailedBalanceAnalysis,
                                          OccupancyCorrelationAnalysis)
        db = DetailedBalanceAnalysis(verbose=args.verbose).run(st)
        note = ("" if len(db.violating_edges_) == 0 else
                f" — edges {db.violating_edges_.tolist()} carry net "
                "flux (field-driven run, unequilibrated relaxation, "
                "or an aliased site)")
        print(f"diagnose: detailed balance — "
              f"{len(db.violating_edges_)}/{db.n_tested_} edges "
              f"violate (worst p = {db.worst_p_:.3g}){note}")
        oc = OccupancyCorrelationAnalysis(verbose=args.verbose).run(st)
        print(f"diagnose: occupancy correlation — "
              f"{len(oc.exclusive_pairs_)} exclusive / "
              f"{len(oc.cofilling_pairs_)} co-filling site pairs "
              f"(|r| >= {oc.threshold:g})")
        if objs is not None:
            objs["ma"] = ma
        pre_note = (" [pre-debounce labels]"
                    if debounce is not None else "")
        if not ma.timescales_.shape[1]:
            print("diagnose: markovianity — n/a "
                  f"(fewer than two live sites){pre_note}")
        else:
            drift = ma.timescale_drift_[0]
            detail = (f"slowest timescale "
                      f"{ma.timescales_[0, 0]:.3g} frames at lag "
                      f"{ma.lags_[0]}, drift "
                      f"{100 * drift:+.0f}% over lags "
                      f"{ma.lags_[0]}..{ma.lags_[-1]}"
                      if np.isfinite(drift) else "slow mode decays "
                      "within the lag grid")
            ck = (f", CK error {ma.ck_error_:.3f}"
                  + ("" if ma.ck_violation_ else " (within noise)")
                  if np.isfinite(ma.ck_error_) else "")
            lag_hint = (f"; rates need lag >= {ma.recommended_lag_}"
                        if ma.recommended_lag_ is not None
                        and ma.recommended_lag_ > int(ma.lags_[0])
                        else "")
            verdict = ("Markovian at this site resolution"
                       if ma.markovian_ else
                       "NON-MARKOVIAN — sites alias hidden states"
                       + lag_hint)
            print(f"diagnose: markovianity — {verdict} "
                  f"({detail}{ck}){pre_note}")
    if getattr(args, "uncertainty", None) is not None:
        _print_uncertainty(args, st, objs=objs)
    if getattr(args, "vacancies", False):
        _print_vacancy_report(args, st)
    if getattr(args, "concerted", False):
        _print_concerted_report(args, st)
    return st


def _print_bottlenecks(args, st_or_sn):
    """Conduction-bottleneck report.  Accepts a SiteTrajectory or a
    SiteNetwork that already carries ``n_ij`` (the streaming route's
    network qualifies without ever loading the spilled labels)."""
    from sitator_tpu.network import ConductionBottleneckAnalysis
    cb = ConductionBottleneckAnalysis(verbose=args.verbose).run(st_or_sn)
    crit = (f"critical sites {cb.critical_sites_.tolist()}"
            if len(cb.critical_sites_) else "no single-site "
            "bottleneck (redundant network)")
    print(f"bottlenecks: base percolation {cb.base_dim_}D; {crit} "
          f"(top betweenness "
          f"{float(cb.betweenness_.max()):.3f})")


def _print_uncertainty(args, st_or_sn, objs=None):
    """Finite-sampling uncertainty report.  Accepts a SiteTrajectory or
    a SiteNetwork with ``n_ij`` (both analyses consume only the jump
    count matrix)."""
    from sitator_tpu.dynamics import (ChainUncertaintyAnalysis,
                                      edge_probability_intervals)
    n = args.uncertainty
    ua = ChainUncertaintyAnalysis(n_samples=n,
                                  verbose=args.verbose).run(st_or_sn)
    edge_probability_intervals(st_or_sn)    # p_ij_lo / p_ij_hi attrs
    if objs is not None:
        objs["ua"] = ua
    t_lo, t_hi = ua.ci_["timescales"]
    t_m = ua.mean_["timescales"]
    if np.isfinite(t_m[0]):
        print(f"uncertainty ({n} posterior draws): slowest "
              f"relaxation {t_m[0]:.4g} frames, 95% CI "
              f"[{t_lo[0]:.4g}, {t_hi[0]:.4g}]; p_ij_lo/p_ij_hi "
              "edge attributes written")
    else:
        print(f"uncertainty ({n} posterior draws): no resolvable "
              "relaxation mode; p_ij_lo/p_ij_hi edge attributes "
              "written")


def _print_vacancy_report(args, st):
    from sitator_tpu.dynamics import JumpAnalysis, VacancyAnalysis
    # identity tracking is O(F * V^3) host work (V = vacancies/frame,
    # upper-bounded by sites - ions): guard the huge-run case the
    # streaming route exists for
    est_v = max(1, st.site_network.n_sites - st.n_mobile)
    if st.n_frames * est_v ** 3 > 2e11:
        print("warning: skipping --vacancies — identity tracking would "
              f"cost ~{st.n_frames} frames x {est_v}^3 Hungarian work; "
              "run VacancyAnalysis on a frame slice or a reduced site "
              "set instead", file=sys.stderr)
        return
    try:
        va = VacancyAnalysis(verbose=args.verbose)
        vt = va.run(st)
    except ValueError as e:
        print(f"vacancies: none ({e})")
        return
    jv = JumpAnalysis(verbose=False)
    jv.run(vt)
    print(f"vacancies: {va.n_vacancies_.min()}-"
          f"{va.n_vacancies_.max()} per frame, "
          f"{va.n_identities_} identities "
          f"({va.n_rebirths_} rebirths), "
          f"{jv.n_jumps} vacancy jumps")


def _print_concerted_report(args, st):
    from sitator_tpu.dynamics import ConcertedJumpAnalysis
    cja = ConcertedJumpAnalysis(window=args.concerted_window,
                                verbose=args.verbose)
    cja.run(st)
    if cja.n_jumps_ == 0:
        print("concerted: no jumps")
        return
    largest = (int(cja.event_n_ions_.max())
               if cja.n_events_ else 0)
    print(f"concerted: {100 * cja.cooperativity_fraction_:.1f}% of "
          f"{cja.n_jumps_} jumps cooperative "
          f"(window {args.concerted_window}); "
          f"{cja.n_ring_events_} rings, {cja.n_chain_events_} chains, "
          f"largest event {largest} ions")


def _parse_tpt_spec(spec):
    """AXIS[:FRAC] → (axis name, axis index, quantile fraction);
    SystemExit on malformed input (called before the pipeline runs)."""
    axis_s, _, frac_s = spec.partition(":")
    axis_s = axis_s.strip().lower()
    try:
        axis = {"x": 0, "y": 1, "z": 2}[axis_s]
    except KeyError:
        raise SystemExit(f"--tpt: axis must be x, y or z "
                         f"(got {axis_s!r})")
    try:
        frac = float(frac_s) if frac_s else 0.15
    except ValueError:
        raise SystemExit(f"--tpt: FRAC must be a number "
                         f"(got {frac_s!r})")
    if not 0.0 < frac < 0.5:
        raise SystemExit("--tpt: FRAC must be in (0, 0.5)")
    return axis_s, axis, frac


def _run_tpt(args, st_or_sn):
    """--tpt AXIS[:FRAC]: transition-path theory between the occupied
    sites in the low/high FRAC quantile of the centers along a
    cartesian axis.  Returns the fitted analysis or None (skips, with
    a reason on stderr, rather than killing the pipeline)."""
    from sitator_tpu.dynamics import TransitionPathAnalysis
    axis_s, axis, frac = _parse_tpt_spec(args.tpt)
    sn = getattr(st_or_sn, "site_network", st_or_sn)
    x = sn.centers[:, axis]
    occ = np.asarray(sn.occupancies)
    lo = np.flatnonzero((x <= np.quantile(x, frac)) & (occ > 0))
    hi = np.flatnonzero((x >= np.quantile(x, 1 - frac)) & (occ > 0))
    if not len(lo) or not len(hi) or len(np.intersect1d(lo, hi)):
        print(f"tpt: skipped — the low/high {frac:g} quantile groups "
              f"along {axis_s} are empty or overlap (too few occupied "
              "sites)", file=sys.stderr)
        return None
    try:
        tpa = TransitionPathAnalysis(sources=lo, sinks=hi,
                                     verbose=args.verbose)
        tpa.run(st_or_sn)
    except ValueError as e:
        print(f"tpt: skipped — {e}", file=sys.stderr)
        return None
    print(f"tpt ({axis_s}): F = {tpa.rate_:.3g} reactive A→B "
          f"transitions/frame per ion (k_AB = {tpa.k_AB_:.3g}); "
          f"{len(tpa.pathways_)} pathway(s) carry "
          f"{100 * tpa.path_flux_fraction_:.0f}% of the net flux")
    for rank, (path, width) in enumerate(tpa.pathways_[:3], 1):
        print(f"tpt:   #{rank} {'-'.join(map(str, path))} "
              f"(width {width:.3g})")
    # in a periodic cell the low/high-coordinate groups are ALSO
    # adjacent through the boundary image — direct A→B hops then say
    # nothing about transport through the cell interior
    direct = float(tpa.net_flux_[np.ix_(lo, hi)].sum())
    total = float(tpa.net_flux_[lo].sum())
    if total > 0 and direct / total > 0.5:
        print(f"tpt: note — {100 * direct / total:.0f}% of the net "
              "flux is direct A→B hops; in a periodic cell the "
              f"low/high-{axis_s} groups touch through the boundary "
              "image, so the pathway decomposition may reflect "
              "boundary adjacency rather than interior transport "
              "(try a larger supercell or explicit site groups via "
              "the TransitionPathAnalysis API)", file=sys.stderr)
    return tpa


def _eager_pipeline(args, sn, traj, objs=None):
    """landmark assignment, then the shared post-processing tail.
    Returns the final SiteTrajectory (jump stats on its network)."""
    from sitator_tpu.landmark import LandmarkAnalysis

    la = LandmarkAnalysis(
        cutoff_midpoint=args.cutoff_midpoint,
        cutoff_steepness=args.cutoff_steepness,
        minimum_site_occupancy=args.min_occupancy,
        dynamic_lattice_mapping=args.dynamic_lattice_mapping,
        verbose=args.verbose)
    st = la.run(sn, traj)
    print(f"assigned: {st.site_network.n_sites} sites, "
          f"{100 * st.percent_unassigned:.2f}% unassigned")
    return _postprocess(args, st, objs)


def _validate_pipe_flags(args):
    """Fail fast on malformed shared-pipeline flags (the pipe parent
    parser is shared by analyze AND arrhenius — validate in one place,
    BEFORE any expensive per-trajectory analysis)."""
    if getattr(args, "merge_metastable", None) is not None and \
            args.merge_metastable != "auto":
        try:
            if int(args.merge_metastable) < 2:
                raise ValueError
        except ValueError:
            raise SystemExit("--merge-metastable takes an integer >= 2 "
                             "or no value (automatic), got "
                             f"{args.merge_metastable!r}")
    if getattr(args, "uncertainty", None) is not None \
            and args.uncertainty < 2:
        raise SystemExit("--uncertainty takes >= 2 posterior draws, "
                         f"got {args.uncertainty}")


def cmd_analyze(args):
    from sitator_tpu.dynamics import DiffusionAnalysis

    if args.tpt:
        _parse_tpt_spec(args.tpt)   # malformed spec fails fast
    _validate_pipe_flags(args)
    reader, sn = _seed_network(args, args.traj)

    if args.streaming:
        ignored = [name for name, val in [
            ("--timestep", args.timestep),
            ("--temperature", args.temperature),
            ("--onsager", args.onsager),
            ("--relaxation", args.relaxation),
            ("--barriers", args.barriers or None),
            ("--report", args.report),
            ("--drift-correction", args.drift_correction),
        ] if val is not None]
        if ignored:
            print(f"warning: {', '.join(ignored)} ignored with "
                  "--streaming (diffusivity needs the materialized "
                  "positions, unavailable out-of-core)",
                  file=sys.stderr)
        needs_labels = [name for name, wanted in [
            ("--merge-dynamics", args.merge_dynamics is not None),
            ("--merge-metastable", args.merge_metastable is not None),
            ("--debounce", args.debounce is not None),
            ("--diagnose", args.diagnose),
            ("--vacancies", args.vacancies),
            ("--concerted", args.concerted),
        ] if wanted]
        # NOT in this list: --uncertainty and --bottlenecks consume
        # only the network's jump-count matrix, which the streaming
        # engine computes on device — they work without --out
        if needs_labels and not args.out:
            print(f"warning: {', '.join(needs_labels)} ignored with "
                  "--streaming unless --out is set (they post-process "
                  "the spilled label file, written next to --out)",
                  file=sys.stderr)
        return _analyze_streaming(args, sn, reader)
    # fail on malformed flag combinations BEFORE the expensive pipeline
    onsager_spec = (_parse_onsager_spec(args.onsager, sn)
                    if args.onsager else None)
    if args.barriers and not args.temperature:
        raise SystemExit("--barriers needs --temperature (kelvin)")
    if args.report:
        try:
            import matplotlib  # noqa: F401 -- the 'full' extra
        except ImportError:
            raise SystemExit("--report needs matplotlib (install the "
                             "'full' extra)")
    traj = reader[0:len(reader)]
    objs = {}
    st = _eager_pipeline(args, sn, traj, objs)

    if args.tpt:
        tpa = _run_tpt(args, st)
        if tpa is not None:
            objs["tpa_flux"] = tpa

    if args.timestep:
        st.set_real_traj(traj)
        da = DiffusionAnalysis(timestep=args.timestep,
                               temperature=args.temperature,
                               charge=args.charge,
                               drift_correction=args.drift_correction,
                               verbose=args.verbose).run(st)
        print(f"D_tracer = {da.D_tracer_:.4g} ± {da.D_tracer_err_:.2g} "
              f"(length²/time units of the input)")
        if np.isfinite(da.anisotropy_):
            print(f"anisotropy λ_max/λ_min = {da.anisotropy_:.3g} "
                  f"(principal D: "
                  f"{', '.join(f'{v:.3g}' for v in da.D_eigvals_[::-1])})")
        if da.conductivity_ is not None:
            print(f"sigma({args.temperature:g} K) = "
                  f"{da.conductivity_:.4g} S/cm")
        objs["da"] = da
        if args.diagnose:
            from sitator_tpu.dynamics import SiteDiffusionAnalysis
            sd = SiteDiffusionAnalysis(timestep=args.timestep,
                                       verbose=args.verbose).run(st)
            print(f"diagnose: D_site/D_tracer = "
                  f"{sd.D_site_ / da.D_tracer_:.3g}, correlation "
                  f"factor f = {sd.f_:.3g}")
            print(f"diagnose: MSD exponent = {da.msd_exponent_:.2f} "
                  f"(diffusive ~1), stationarity D2/D1 = "
                  f"{da.stationarity_ratio_:.2f} (stationary ~1)")
            objs["sd"] = sd

    if args.barriers:
        from sitator_tpu.dynamics import PathwayBarrierAnalysis
        st.set_real_traj(traj)
        pa = PathwayBarrierAnalysis(temperature=args.temperature,
                                    min_jumps=args.barriers_min_jumps,
                                    path=args.barriers_path,
                                    verbose=args.verbose).run(st)
        E = st.site_network.density_barrier_ij
        finite = E[np.isfinite(E)]
        objs["pa"] = pa
        if len(finite):
            print(f"density barriers: {len(finite)} directed edges, "
                  f"median {np.median(finite):.3g} eV "
                  f"(range [{finite.min():.3g}, {finite.max():.3g}]; "
                  f"saved as edge attr density_barrier_ij)")
        else:
            print("density barriers: no edge with enough sampling")

    if args.relaxation:
        from sitator_tpu.dynamics import RelaxationAnalysis
        ra = RelaxationAnalysis(q=args.relaxation,
                                timestep=args.timestep or 1.0,
                                drift_correction=args.drift_correction,
                                verbose=args.verbose).run(
            traj, mobile_mask=sn.mobile_mask, cell=sn.structure.cell)
        unit = "ps" if args.timestep else "frames"
        peak_t = ra.times_[int(np.argmax(ra.alpha2_))]
        objs["ra"] = ra
        print(f"relaxation (q = {args.relaxation:g} 1/Å): alpha2 peak "
              f"{ra.alpha2_.max():.3g} at t = {peak_t:.4g} {unit}; "
              f"tau_alpha = {ra.tau_alpha_:.4g} {unit}")

    if onsager_spec is not None:
        objs["oa"] = _run_onsager(args, sn, traj, onsager_spec)

    if args.out:
        st.save(args.out)
        print(f"results saved to {args.out}")
    if args.report:
        # the analysis is already saved — a report failure must never
        # cost the run
        try:
            _write_report(args, st, objs)
        except Exception as e:
            print(f"warning: report generation failed: {e}",
                  file=sys.stderr)
    return 0


def _parse_onsager_spec(spec, sn):
    """Validate "SPECIES:CHARGE,..." against the structure — returns
    (groups, charges, names).  Raises SystemExit with a usage message
    on any malformed part, so callers can run it BEFORE the pipeline."""
    groups, charges, names = [], [], []
    for part in spec.split(","):
        sp, sep, ch = part.partition(":")
        sp = sp.strip()
        if not sep or not ch.strip():
            raise SystemExit(f"--onsager: '{part}' is not "
                             "SPECIES:CHARGE (e.g. Li:+1,Cl:-1)")
        if sp in names:
            raise SystemExit(f"--onsager: species {sp!r} listed twice")
        try:
            num = _species_arg(sp)
        except ValueError as e:
            raise SystemExit(f"--onsager: {e}")
        mask = np.asarray(sn.structure.species) == num
        if not mask.any():
            raise SystemExit(f"--onsager: no atoms of species {sp!r}")
        try:
            charges.append(float(ch))
        except ValueError:
            raise SystemExit(f"--onsager: bad charge {ch.strip()!r} in "
                             f"'{part}' (expected e.g. Li:+1)")
        groups.append(mask)
        names.append(sp)
    return groups, charges, names


def _run_onsager(args, sn, traj, spec):
    """--onsager "SPECIES:CHARGE,..." → Onsager matrix, transference
    numbers, and (with --timestep and --temperature) conductivity."""
    from sitator_tpu.dynamics import OnsagerAnalysis
    groups, charges, names = spec
    temperature = args.temperature
    if temperature is not None and not args.timestep:
        print("warning: --onsager conductivity needs --timestep (ps) "
              "for physical units; skipping sigma", file=sys.stderr)
        temperature = None
    drift = args.drift_correction
    if drift == "static":                  # raw-traj mode needs a mask
        drift = np.asarray(sn.static_mask, dtype=bool)
    oa = OnsagerAnalysis(groups, timestep=args.timestep or 1.0,
                         temperature=temperature, charges=charges,
                         drift_correction=drift,
                         verbose=args.verbose).run(
        traj, cell=sn.structure.cell)
    unit = "Å²/ps" if args.timestep else "Å²/frame"
    print(f"Onsager matrix ({unit}, extensive):")
    for i, name in enumerate(names):
        row = "  ".join(f"{v:10.4g}" for v in oa.L_[i])
        print(f"  {name:>4s} [{row}]")
    tr = ", ".join(f"t_{n} = {t:.3f}"
                   for n, t in zip(names, oa.transference_))
    print(f"transference: {tr}")
    if oa.conductivity_ is not None:
        print(f"sigma_Onsager({temperature:g} K) = "
              f"{oa.conductivity_:.4g} S/cm")
    oa.names_ = names                      # for the report
    return oa


def cmd_sites(args):
    """Trajectory-free site screening: structure file → candidate
    sites (Voronoi geometry or bond-valence chemistry)."""
    from sitator_tpu import SiteNetwork
    from sitator_tpu.core.structure import number_to_symbol
    from sitator_tpu.io.formats import read_structure

    s = read_structure(args.structure_file)
    if args.supercell:
        s = s.repeat(args.supercell)
        print(f"supercell {tuple(args.supercell)}: {s.n_atoms} atoms")
    mobile = np.isin(s.species, args.mobile)
    sn0 = SiteNetwork(s, ~mobile, mobile)
    if args.method == "bv":
        from sitator_tpu.network import BondValenceSiteGenerator
        cation = number_to_symbol(int(args.mobile[0]))
        if len(args.mobile) > 1:
            print(f"note: bond-valence screening uses ONE cation — "
                  f"screening for {cation} (the other --mobile species "
                  "only shape the mobile mask)", file=sys.stderr)
        try:
            sn = BondValenceSiteGenerator(
                cation=cation, v_ideal=args.bv_valence,
                mismatch_tol=args.bv_mismatch_tol,
                verbose=args.verbose).run(sn0)
        except ValueError as e:
            raise SystemExit(f"sites: {e}")
        print(f"{sn.n_sites} bond-valence sites for {cation} "
              f"(|V-{args.bv_valence:g}| < {args.bv_mismatch_tol:g}; "
              f"best mismatch {float(np.min(sn.bv_mismatch)):.3g})")
    else:
        from sitator_tpu.voronoi import VoronoiSiteGenerator
        sn = VoronoiSiteGenerator(
            merge_tol=args.voronoi_merge_tol).run(sn0)
        print(f"{sn.n_sites} Voronoi sites")
    if args.out:
        sn.save(args.out)
        print(f"site network saved to {args.out}")
    if args.xyz:
        from sitator_tpu.io.formats import write_structure
        write_structure(args.xyz, sn.get_structure_with_sites())
        print(f"structure + sites (species 0 markers) written to "
              f"{args.xyz}")
    return 0


def _write_report(args, st, objs):
    """--report DIR: a self-contained markdown report with figures for
    everything this run computed (no extra analysis is performed)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from sitator_tpu import __version__

    outdir = args.report
    os.makedirs(outdir, exist_ok=True)
    sn = st.site_network
    n_ij = (np.asarray(sn.n_ij) if sn.has_attribute("n_ij") else None)
    lines = ["# sitator_tpu analysis report", "",
             f"- generated by sitator_tpu {__version__}",
             f"- trajectory: `{args.traj}`",
             f"- frames: {st.n_frames}; mobile ions: {st.n_mobile}",
             f"- sites: {sn.n_sites}"
             + (f"; jumps: {int(n_ij.sum() - np.trace(n_ij))}"
                if n_ij is not None else ""),
             ""]
    figures = []
    try:
        from sitator_tpu.visualization import SiteNetworkPlotter
        fig = SiteNetworkPlotter(site_size_attr="occupancies").plot(sn)
        figures.append(("site_network.png", fig,
                        "Site network (marker size = occupancy, edge "
                        "width = hop counts)"))
    except Exception as e:          # plotting must never kill a report
        lines.append(f"(site-network figure skipped: {e})")

    da = objs.get("da")
    if da is not None:
        lines += [
            "## Transport", "",
            f"- D_tracer = {da.D_tracer_:.4g} ± {da.D_tracer_err_:.2g}"
            " (length²/time of the input)",
            f"- D_collective = {da.D_collective_:.4g}; Haven ratio = "
            f"{da.haven_ratio_:.3g}",
            f"- MSD exponent = {da.msd_exponent_:.2f} (diffusive ~1); "
            f"stationarity D2/D1 = {da.stationarity_ratio_:.2f}",
        ]
        if da.conductivity_ is not None:
            lines.append(f"- sigma({args.temperature:g} K) = "
                         f"{da.conductivity_:.4g} S/cm")
        lines.append("")
        from sitator_tpu.visualization import plot_msd
        figures.append(("msd.png", plot_msd(da), "MSD and fit window"))
    sd = objs.get("sd")
    if sd is not None:
        lines += [f"- D_site/D_tracer = "
                  f"{sd.D_site_ / da.D_tracer_:.3g}; correlation "
                  f"factor f = {sd.f_:.3g}", ""]
    oa = objs.get("oa")
    if oa is not None:
        lines += ["## Onsager transport", ""]
        if oa.transference_ is not None:
            names = getattr(oa, "names_",
                            [str(i) for i in range(len(oa.transference_))])
            lines.append("- transference: " + ", ".join(
                f"t_{n} = {t:.3f}"
                for n, t in zip(names, oa.transference_)))
        if oa.conductivity_ is not None:
            lines.append(f"- sigma_Onsager = "
                         f"{oa.conductivity_:.4g} S/cm")
        lines.append("")
    ra = objs.get("ra")
    if ra is not None:
        lines += ["## Relaxation", "",
                  f"- alpha2 peak = {ra.alpha2_.max():.3g}; tau_alpha "
                  f"= {ra.tau_alpha_:.4g}", ""]
    pa = objs.get("pa")
    if pa is not None and pa.profiles_:
        E = sn.density_barrier_ij
        finite = E[np.isfinite(E)]
        lines += ["## Pathway barriers (density route)", "",
                  f"- {len(finite)} directed edges; median "
                  f"{np.median(finite):.3g} eV", ""]
        from sitator_tpu.visualization import plot_barrier_profiles
        figures.append(("barriers.png", plot_barrier_profiles(pa),
                        "Free-energy profiles along hop paths"))
    ma = objs.get("ma")
    if ma is not None and ma.timescales_.shape[1]:
        verdict = ("Markovian at this site resolution" if ma.markovian_
                   else "NON-Markovian — sites alias hidden states")
        drift = ma.timescale_drift_[0]
        detail = (f"- slowest implied timescale "
                  f"{ma.timescales_[0, 0]:.4g} frames at lag "
                  f"{int(ma.lags_[0])}; drift over lags "
                  f"{int(ma.lags_[0])}..{int(ma.lags_[-1])}: "
                  f"{100 * drift:+.0f}%"
                  if np.isfinite(drift) else
                  "- slow mode decays within the lag grid "
                  "(timescales unresolvable at these lags)")
        lines += ["## Markovianity of the site chain", "",
                  f"- {verdict}", detail]
        if np.isfinite(ma.ck_error_):
            lines.append(
                f"- Chapman–Kolmogorov max error {ma.ck_error_:.3f}"
                + ("" if ma.ck_violation_
                   else " (within sampling noise)"))
        if ma.recommended_lag_ is not None:
            lines.append(f"- recommended estimation lag: "
                         f"{ma.recommended_lag_} frames")
        lines.append("")
        from sitator_tpu.visualization import (plot_ck_test,
                                               plot_implied_timescales)
        figures.append(("implied_timescales.png",
                        plot_implied_timescales(ma),
                        "Implied timescales vs lag (flat = Markovian; "
                        "grey region unresolvable)"))
        if ma.ck_measured_.size:
            figures.append(("ck_test.png", plot_ck_test(ma),
                            "Chapman–Kolmogorov test on metastable "
                            "sets (points: measured ±1σ; dashed: "
                            "base-lag model)"))
    ua = objs.get("ua")
    if ua is not None:
        t_m = ua.mean_["timescales"]
        t_lo, t_hi = ua.ci_["timescales"]
        lines += ["## Finite-sampling uncertainty "
                  f"({ua.n_samples} posterior draws)", ""]
        for k in range(len(t_m)):
            if np.isfinite(t_m[k]):
                lines.append(f"- relaxation timescale t{k + 1} = "
                             f"{t_m[k]:.4g} frames, 95% CI "
                             f"[{t_lo[k]:.4g}, {t_hi[k]:.4g}]")
        lines += ["- per-edge `p_ij_lo` / `p_ij_hi` credible "
                  "intervals saved as edge attributes", ""]
    tpa = objs.get("tpa_flux")
    if tpa is not None:
        lines += ["## Transition-path theory", "",
                  f"- F = {tpa.rate_:.4g} reactive A→B transitions "
                  f"per frame per ion (k_AB = {tpa.k_AB_:.4g})",
                  f"- {len(tpa.pathways_)} dominant pathway(s) carry "
                  f"{100 * tpa.path_flux_fraction_:.0f}% of the net "
                  "flux", ""]
        for rank, (path, width) in enumerate(tpa.pathways_, 1):
            lines.append(f"  {rank}. {' → '.join(map(str, path))} "
                         f"(width {width:.3g})")
        lines.append("")
        from sitator_tpu.visualization import plot_reactive_flux
        figures.append(("reactive_flux.png",
                        plot_reactive_flux(tpa, sn),
                        "Reactive-flux network (x = forward "
                        "committor; dominant pathways highlighted)"))

    for fname, fig, caption in figures:
        fig.savefig(os.path.join(outdir, fname), dpi=130,
                    bbox_inches="tight")
        plt.close(fig)
        lines += [f"![{caption}]({fname})", "", f"*{caption}*", ""]
    path = os.path.join(outdir, "report.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"report written to {path} ({len(figures)} figures)")


def _analyze_streaming(args, sn, reader):
    """Out-of-core route: the streaming engine never materializes the
    trajectory; labels spill to ``OUT.labels.npy`` when --out is set.
    Label-based post-processing (merging, debounce, --diagnose) runs
    from the spilled file afterwards — only diffusivity (which needs
    the real positions) is unavailable out-of-core."""
    from sitator_tpu.landmark.streaming import StreamingLandmarkAnalysis

    labels_path = (args.out + ".labels.npy") if args.out else None
    eng = StreamingLandmarkAnalysis(
        cutoff_midpoint=args.cutoff_midpoint,
        cutoff_steepness=args.cutoff_steepness,
        minimum_site_occupancy=args.min_occupancy,
        dynamic_lattice_mapping=args.dynamic_lattice_mapping,
        block_frames=args.block_frames,
        store_labels=labels_path,
        checkpoint_path=(args.out + ".ckpt") if args.out else None,
        verbose=args.verbose)
    sn2 = eng.run(sn, reader)
    n_jumps = int(sn2.n_ij.sum() - np.trace(sn2.n_ij))
    print(f"streamed {len(reader)} frames: {sn2.n_sites} sites, "
          f"{n_jumps} jumps")

    # transforming flags change the artifact (labels relabeled, stats
    # recomputed); --diagnose alone is observational and must not
    transform = (args.merge_dynamics is not None
                 or args.merge_metastable is not None
                 or args.debounce is not None)
    st = None
    if labels_path and (transform or args.diagnose or args.vacancies
                        or args.concerted):
        from sitator_tpu.core.sitetraj import SiteTrajectory
        # mmap: the labels are int32 (F, M) — small next to the
        # positions this route deliberately never materializes, but a
        # north-star-scale run's labels are still GB-scale
        labels = np.load(labels_path, mmap_mode="r")
        if transform:
            print("post-processing from the spilled label file")
            st = _postprocess(args, SiteTrajectory(sn2, labels))
        else:
            st_obs = SiteTrajectory(sn2, labels)
            if args.diagnose:
                _print_residence_diagnose(args, st_obs)
            if args.vacancies:
                _print_vacancy_report(args, st_obs)
            if args.concerted:
                _print_concerted_report(args, st_obs)

    if st is None:
        # transform-free streaming run: _postprocess never ran, but
        # these consume only the network's jump-count matrix, which
        # the streamed network already carries — no label load needed
        if getattr(args, "bottlenecks", False):
            _print_bottlenecks(args, sn2)
        if getattr(args, "uncertainty", None) is not None:
            _print_uncertainty(args, sn2)

    if args.tpt:
        # after any label post-processing; TPT only needs the
        # network's jump statistics, available on both routes
        _run_tpt(args, st if st is not None else sn2)

    if args.out:
        if st is not None:
            st.save(args.out)
            print(f"site trajectory saved to {args.out}; raw labels in "
                  f"{labels_path}")
        else:
            sn2.save(args.out)
            print(f"site network saved to {args.out}; labels in "
                  f"{labels_path}")
    return 0


def cmd_arrhenius(args):
    from sitator_tpu.dynamics import (ArrheniusAnalysis,
                                      DiffusionAnalysis,
                                      EdgeArrheniusAnalysis)
    # parse + validate the whole series BEFORE any expensive analysis
    _validate_pipe_flags(args)
    parsed = []
    for spec in args.series:
        if "=" not in spec:
            raise SystemExit(
                f"series entries must be TEMP=PATH (got {spec!r}), "
                "e.g. 700=md700.xyz 900=md900.xyz")
        t_str, path = spec.split("=", 1)
        try:
            parsed.append((float(t_str), path))
        except ValueError:
            raise SystemExit(f"bad temperature in {spec!r}")
    if len(parsed) < 2:
        raise SystemExit("need at least 2 TEMP=PATH entries")
    if len({t for t, _ in parsed}) < 2:
        raise SystemExit("need at least 2 distinct temperatures")

    series, temps, Ds, Derrs = [], [], [], []
    for T, path in parsed:
        print(f"--- T = {T:g} K: {path}")
        reader, sn = _seed_network(args, path)
        traj = reader[0:len(reader)]
        st = _eager_pipeline(args, sn, traj)
        series.append((T, st.site_network))
        if args.timestep:
            st.set_real_traj(traj)
            da = DiffusionAnalysis(timestep=args.timestep,
                                   verbose=args.verbose).run(st)
            print(f"D_tracer = {da.D_tracer_:.4g} ± "
                  f"{da.D_tracer_err_:.2g}")
            temps.append(T)
            Ds.append(da.D_tracer_)
            Derrs.append(da.D_tracer_err_)

    if args.timestep:
        if all(d > 0 for d in Ds):
            aa = ArrheniusAnalysis(verbose=args.verbose).run(
                temps, Ds, errors=Derrs)
            print(f"tracer-D Arrhenius: Ea = {aa.Ea_ev_:.4g} ± "
                  f"{aa.Ea_err_ev_:.2g} eV "
                  f"(prefactor {aa.prefactor_:.4g})")
        else:
            print("warning: non-positive D in the series — scalar "
                  "Arrhenius fit skipped", file=sys.stderr)

    ea = EdgeArrheniusAnalysis(min_counts=args.min_counts,
                               match_cutoff=args.match_cutoff,
                               verbose=args.verbose).run(series)
    fitted = int(np.isfinite(ea.Ea_ij_).sum())
    if fitted:
        print(f"edge Arrhenius: {fitted} pathways fitted; "
              f"median Ea = {np.nanmedian(ea.Ea_ij_):.4g} eV; "
              f"site-level median = "
              f"{np.nanmedian(ea.Ea_site_):.4g} eV")
    else:
        print("edge Arrhenius: no pathway observed at enough "
              "temperatures (lower --min-counts or collect more "
              "frames)")
    if args.out:
        series[0][1].save(args.out)
        print(f"reference network (with Ea_ij/Ea_site) saved to "
              f"{args.out}")
    return 0


def cmd_doctor(args):
    """Environment / accelerator report: versions, backend, devices, and
    the wall time of a probe matmul (compile + run + fetch)."""
    import platform
    import time

    import sitator_tpu
    print(f"sitator_tpu {getattr(sitator_tpu, '__version__', '?')}  "
          f"python {platform.python_version()}  ({platform.platform()})")
    t0 = time.perf_counter()
    import jax
    import jax.numpy as jnp
    print(f"jax {jax.__version__}  import {time.perf_counter() - t0:.1f}s")
    backend = jax.default_backend()
    devices = jax.devices()
    kinds = sorted({d.device_kind for d in devices})
    print(f"backend: {backend}  devices: {len(devices)} "
          f"({', '.join(kinds)})")
    if backend == "cpu":
        print("note: CPU backend — fine for analysis, not a "
              "performance target")
    t1 = time.perf_counter()
    n = args.probe_size
    r = np.asarray(jax.jit(lambda a, b: a @ b)(
        jnp.ones((n, n), jnp.bfloat16), jnp.ones((n, n), jnp.bfloat16)))
    dt = time.perf_counter() - t1
    print(f"probe: {n}x{n} bf16 matmul compile+run+fetch "
          f"{dt:.1f}s (checksum {float(r.sum()):.3g})")
    print("healthy")
    return 0


def build_parser():
    p = argparse.ArgumentParser(
        prog="sitator_tpu",
        description="accelerated site-trajectory analysis pipeline")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("info", help="describe a trajectory file")
    q.add_argument("traj")
    q.add_argument("--variable-cell", choices=["rescale"], default=None)
    q.set_defaults(func=cmd_info)

    c = sub.add_parser("convert",
                       help="convert to .npy / zarr (O(1) memory)")
    c.add_argument("traj")
    c.add_argument("out")
    c.add_argument("--variable-cell", choices=["rescale"], default=None)
    c.add_argument("--zarr", action="store_true",
                   help="force a zarr store regardless of extension")
    c.add_argument("--zarr3", action="store_true",
                   help="zarr v3 instead of v2")
    c.set_defaults(func=cmd_convert)

    w = sub.add_parser(
        "sites",
        help="trajectory-free site screening from a structure file "
             "(xyz / POSCAR / CIF): Voronoi geometry or bond-valence "
             "chemistry")
    w.add_argument("structure_file")
    w.add_argument("--mobile", type=_species_arg, nargs="+",
                   required=True,
                   help="the cation to screen sites for")
    w.add_argument("--method", choices=["voronoi", "bv"],
                   default="voronoi")
    w.add_argument("--supercell", type=int, nargs=3, default=None,
                   metavar=("NX", "NY", "NZ"),
                   help="tile the structure first (small unit cells)")
    w.add_argument("--bv-valence", type=float, default=1.0)
    w.add_argument("--bv-mismatch-tol", type=float, default=0.5)
    w.add_argument("--voronoi-merge-tol", type=float, default=0.05)
    w.add_argument("--out", default=None, metavar="OUT.npz",
                   help="save the seeded SiteNetwork")
    w.add_argument("--xyz", default=None, metavar="SITES.xyz",
                   help="write structure + site markers (format by "
                        "extension: xyz / .cif / POSCAR)")
    w.set_defaults(func=cmd_sites)

    d = sub.add_parser("doctor",
                       help="environment / accelerator report "
                            "(backend, devices, probe matmul)")
    d.add_argument("--probe-size", type=int, default=256)
    d.set_defaults(func=cmd_doctor)

    # options shared by the analyze and arrhenius pipelines
    pipe = argparse.ArgumentParser(add_help=False)
    pipe.add_argument("--mobile", type=_species_arg, nargs="+",
                      required=True, metavar="SPECIES",
                      help="mobile species (symbol or atomic number)")
    pipe.add_argument("--structure", default=None,
                      help="structure file with species + cell for "
                           "binary formats that carry none: extended "
                           ".xyz, VASP POSCAR/CONTCAR, or a .cif "
                           "(symmetry expanded)")
    pipe.add_argument("--variable-cell", choices=["rescale"],
                      default=None)
    pipe.add_argument("--cutoff-midpoint", type=float, default=3.0)
    pipe.add_argument("--cutoff-steepness", type=float, default=4.0)
    pipe.add_argument("--min-occupancy", type=float, default=0.01)
    pipe.add_argument("--voronoi-merge-tol", type=float, default=0.05)
    pipe.add_argument("--sites", choices=["voronoi", "density", "bv"],
                      default="voronoi",
                      help="landmark-basis seeding: empty-lattice "
                           "Voronoi nodes (default), mobile-ion "
                           "density maxima (occupied basins only; "
                           "finds interstitials geometry misses), or "
                           "bond-valence mismatch minima (chemistry "
                           "only — no trajectory needed)")
    pipe.add_argument("--density-frames", type=int, default=2000,
                      help="~frames sampled for --sites density "
                           "(strided across the whole run)")
    pipe.add_argument("--bv-valence", type=float, default=1.0,
                      help="target bond-valence sum for --sites bv "
                           "(the mobile cation's formal valence)")
    pipe.add_argument("--bv-mismatch-tol", type=float, default=0.5,
                      help="acceptance |V - valence| for --sites bv")
    pipe.add_argument("--dynamic-lattice-mapping", action="store_true")
    pipe.add_argument("--merge-dynamics", type=float, default=None,
                      metavar="DIST",
                      help="MergeSitesByDynamics distance threshold")
    pipe.add_argument("--merge-metastable", default=None, nargs="?",
                      const="auto", metavar="N",
                      help="merge sites into metastable kinetic basins "
                           "via the chain's slow spectrum (PCCA); N "
                           "basins, or spectral-gap automatic when "
                           "given without a value (runs after "
                           "--merge-dynamics if both are set)")
    pipe.add_argument("--uncertainty", type=int, default=None,
                      nargs="?", const=200, metavar="N",
                      help="Bayesian finite-sampling uncertainty of the "
                           "measured chain (Dirichlet posterior, N "
                           "draws, default 200): credible interval on "
                           "the slowest relaxation; per-edge "
                           "p_ij_lo/p_ij_hi attributes in the saved "
                           "results")
    pipe.add_argument("--debounce", type=int, default=None,
                      metavar="FRAMES",
                      help="RemoveShortJumps frame threshold")
    pipe.add_argument("--keep-unoccupied", action="store_true")
    pipe.add_argument("--timestep", type=float, default=None,
                      help="time between frames — enables "
                           "DiffusionAnalysis")

    a = sub.add_parser("analyze", parents=[pipe],
                       help="run the full landmark pipeline")
    a.add_argument("traj")
    a.add_argument("--diagnose", action="store_true",
                   help="residence-time memorylessness check (flags "
                        "over-merged sites) and, with --timestep, the "
                        "site-discretization/correlation-factor report")
    a.add_argument("--vacancies", action="store_true",
                   help="track vacancies as identity-labeled "
                        "quasi-particles and report their jump count")
    a.add_argument("--concerted", action="store_true",
                   help="group jumps into cooperative events via site "
                        "handoffs; report the cooperativity fraction "
                        "and ring/chain split")
    a.add_argument("--concerted-window", type=int, default=1,
                   metavar="FRAMES",
                   help="max frame separation for a handoff link")
    a.add_argument("--streaming", action="store_true",
                   help="out-of-core streaming engine (huge files; "
                        "stats from device accumulators, labels spill "
                        "next to --out)")
    a.add_argument("--block-frames", type=int, default=1024,
                   help="frames per streamed device block")
    a.add_argument("--onsager", default=None, metavar="SPEC:Q,...",
                   help="Onsager matrix between species groups, e.g. "
                        "'Li:+1,Cl:-1' — transference numbers and "
                        "(with --timestep/--temperature) the "
                        "pairing-aware conductivity")
    a.add_argument("--tpt", default=None, metavar="AXIS[:FRAC]",
                   help="transition-path theory between the occupied "
                        "sites in the low/high FRAC (default 0.15) "
                        "quantile of the site centers along AXIS "
                        "(x|y|z): committors, A→B rate, dominant "
                        "pathways")
    a.add_argument("--bottlenecks", action="store_true",
                   help="rate-weighted betweenness + site-removal "
                        "percolation experiments (which sites, if "
                        "blocked, kill long-range transport)")
    a.add_argument("--barriers", action="store_true",
                   help="free-energy barriers along observed hop paths "
                        "from the occupation density (-kT ln rho; "
                        "needs --temperature); edge attr "
                        "density_barrier_ij on the saved network")
    a.add_argument("--barriers-min-jumps", type=int, default=2,
                   help="profile only edges with at least this many "
                        "observed hops")
    a.add_argument("--barriers-path", choices=("straight", "string"),
                   default="straight",
                   help="hop-path model: the straight minimum-image "
                        "segment (upper-bound proxy) or a string-method "
                        "minimum-energy path relaxed on -kT ln rho "
                        "(reads the true saddle of curved mechanisms)")
    a.add_argument("--relaxation", type=float, default=None, metavar="Q",
                   help="dynamic heterogeneity at wavevector Q (1/Å): "
                        "non-Gaussian alpha2(t) peak and the self-"
                        "intermediate-scattering relaxation time "
                        "tau_alpha (natural Q: 2*pi over the jump "
                        "length)")
    a.add_argument("--drift-correction", choices=["static", "all"],
                   default=None,
                   help="pin diffusivity/Onsager analyses to the mean "
                        "frame of the host lattice ('static') or all "
                        "atoms ('all') — removes thermostat/host drift")
    a.add_argument("--temperature", type=float, default=None,
                   help="kelvin — adds Nernst-Einstein conductivity")
    a.add_argument("--charge", type=float, default=1.0)
    a.add_argument("--report", default=None, metavar="DIR",
                   help="write a markdown report (+ figures) of "
                        "everything this run computed into DIR")
    a.add_argument("--out", default=None, metavar="OUT.npz",
                   help="save the SiteTrajectory (+ network) here")
    a.set_defaults(func=cmd_analyze)

    r = sub.add_parser(
        "arrhenius", parents=[pipe],
        help="activation energies from a temperature series "
             "(independent runs, site-matched)")
    r.add_argument("series", nargs="+", metavar="TEMP=PATH",
                   help="temperature (kelvin) and trajectory pairs, "
                        "e.g. 700=md700.xyz 900=md900.xyz")
    r.add_argument("--min-counts", type=int, default=3,
                   help="minimum hops for a (T, edge) point to enter "
                        "its fit")
    r.add_argument("--match-cutoff", type=float, default=2.0,
                   metavar="DIST",
                   help="max site-matching distance across "
                        "temperatures")
    r.add_argument("--out", default=None, metavar="OUT.npz",
                   help="save the reference network (with Ea_ij / "
                        "Ea_site attributes) here")
    r.set_defaults(func=cmd_arrhenius)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from sitator_tpu.util.compile_cache import enable_compile_cache
    enable_compile_cache()
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
