"""The examples are the de-facto integration tests of the reference
ecosystem (SURVEY.md §5) — so they run under CI: each walkthrough executes
in a subprocess exactly as a user would invoke it (bare
``python examples/<name>.py``; every example pins its own CPU backend via
``examples/_common.py``), and must exit 0 printing its key result lines.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = {
    "landmark_walkthrough.py": [
        "pathways: 1", "saved to /tmp/walkthrough_result.npz"],
    "fcc_tet_oct.py": [
        "every discovered site within", "FCC walkthrough complete."],
    "streaming_and_typing.py": [
        "streamed (raw):", "site types:"],
    "formats_and_lattice_mapping.py": [
        "StaticLatticeError",
        "statistics identical to the unswapped run"],
    "npt_variable_cell.py": [
        "rescale bridge: max |bridged",
        "NPT walkthrough complete."],
    "zarr_and_smeared_soap.py": [
        "bit-identical",
        "delta vs gauss typing agreement: 100%"],
    "multichip_mesh.py": [
        "8-device run is bit-identical to the single-device run."],
    "diffusion_kinetics.py": [
        "D_tracer", "Haven ratio", "Nernst-Einstein", "cooperativity:",
        "equilibration: MSD exponent", "drift demo:",
        "sigma(omega): DC plateau",
        "Diffusion walkthrough complete."],
    "temperature_series.py": [
        "site match", "tracer-D Arrhenius", "edge Arrhenius",
        "Temperature-series walkthrough complete."],
    "msm_validation.py": [
        "recommended estimation lag",
        "the true body-center count",
        "merge withheld",
        "recovered partition == the original site decomposition",
        "95% credible",
        "MSM validation walkthrough complete."],
    "density_sites.py": [
        "matched within 0.5 Angstrom",
        "interstitial basin recovered",
        "bond-valence seeding: 32 sites",
        "Density-seeding walkthrough complete."],
    "structure_screening.py": [
        "after symmetry expansion",
        "every BV site sits on a Voronoi candidate",
        "round-trip through read_structure",
        "Structure-screening walkthrough complete."],
}


def _run(name, extra_env=None):
    env = dict(os.environ)
    # never inherit a platform override from the caller's shell: a leaked
    # SITATOR_EXAMPLES_PLATFORM=gpu would route 7 concurrent subprocesses
    # at one card
    env.pop("SITATOR_EXAMPLES_PLATFORM", None)
    env.update(extra_env or {})
    proc = subprocess.run(
        [sys.executable, os.path.join("examples", name)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (
        f"{name} exited {proc.returncode}\n--- stdout ---\n"
        f"{proc.stdout[-4000:]}\n--- stderr ---\n{proc.stderr[-4000:]}")
    return proc.stdout


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs(name):
    out = _run(name)
    for key in EXAMPLES[name]:
        assert key in out, (
            f"{name}: expected {key!r} in output\n--- stdout ---\n"
            f"{out[-4000:]}")


def test_examples_all_listed():
    """Every walkthrough in examples/ is under test (a new example must
    register its key output lines above)."""
    on_disk = {f for f in os.listdir(os.path.join(REPO, "examples"))
               if f.endswith(".py") and not f.startswith("_")}
    assert on_disk == set(EXAMPLES)


def test_example_overrides_hostile_platform_pin():
    """The examples must self-force CPU even when the environment pins an
    accelerator platform (the trap: JAX_PLATFORMS alone can be re-pinned
    by a site customization; _common.default_to_cpu() overrides both)."""
    out = _run("landmark_walkthrough.py",
               extra_env={"JAX_PLATFORMS": "cuda"})
    assert "saved to /tmp/walkthrough_result.npz" in out
