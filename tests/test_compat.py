"""The reference-namespace shim: unmodified ``sitator`` imports run the
sitator_tpu implementations (SURVEY.md §2-§3 layout)."""
import subprocess
import sys

import numpy as np
import pytest

import sitator_tpu
from sitator_tpu import compat


@pytest.fixture()
def shim():
    compat.install()
    yield
    compat.uninstall()


def test_reference_import_styles(shim):
    # package re-export style
    from sitator import SiteNetwork, SiteTrajectory, Structure
    from sitator.landmark import LandmarkAnalysis, StaticLatticeError
    from sitator.voronoi import VoronoiSiteGenerator
    from sitator.dynamics import JumpAnalysis, MergeSitesByDynamics
    from sitator.network import DiffusionPathwayAnalysis
    from sitator.site_descriptors import SiteTypeAnalysis
    from sitator.util import PBCCalculator, DotProdClassifier
    from sitator.misc import NAvgsPerSite
    from sitator.visualization import SiteNetworkPlotter

    # one-class-per-CamelCase-file style (reference file layout)
    from sitator.SiteNetwork import SiteNetwork as SN2
    from sitator.dynamics.JumpAnalysis import JumpAnalysis as JA2
    from sitator.util.PBCCalculator import PBCCalculator as PBC2
    from sitator.site_descriptors.SOAP import SOAPDescriptorAverages
    import sitator.util.zeo
    import sitator.landmark.cluster.dotprod as dp

    assert SN2 is SiteNetwork is sitator_tpu.SiteNetwork
    assert JA2 is JumpAnalysis
    assert PBC2 is PBCCalculator
    assert callable(dp.do_landmark_clustering)
    assert hasattr(sitator.util.zeo, "Zeopy")

    import sitator
    assert sitator.__version__ == sitator_tpu.__version__


def test_file_module_style_full_surface(shim):
    """Every engine class is importable in the reference's
    one-class-per-file style, from the parent(s) SURVEY §3.4-§3.8 names."""
    from sitator.dynamics.MergeSitesByDistance import MergeSitesByDistance
    from sitator.network.MergeSitesByDistance import (
        MergeSitesByDistance as MSD2)
    from sitator.network.SiteVolumes import SiteVolumes
    from sitator.site_descriptors.MergeSitesByDescriptors import (
        MergeSitesByDescriptors)
    from sitator.misc.RecenterTrajectory import RecenterTrajectory
    from sitator.visualization.common import plotter, layers
    from sitator.visualization.atoms import plot_atoms
    import sitator.landmark.cluster.mcl as mcl_mod

    assert MSD2 is MergeSitesByDistance
    assert callable(mcl_mod.do_landmark_clustering)
    for cls in (SiteVolumes, MergeSitesByDescriptors, RecenterTrajectory):
        assert hasattr(cls, "run")
    assert callable(plotter) and callable(layers) and callable(plot_atoms)


def test_every_package_export_reachable(shim):
    """The whole public surface of each sitator_tpu subpackage is visible
    through its compat alias (guards against __all__ drift)."""
    import importlib
    for ref, pkg in [("sitator.dynamics", "sitator_tpu.dynamics"),
                     ("sitator.network", "sitator_tpu.network"),
                     ("sitator.site_descriptors",
                      "sitator_tpu.site_descriptors"),
                     ("sitator.misc", "sitator_tpu.misc"),
                     ("sitator.visualization", "sitator_tpu.visualization"),
                     ("sitator.util", "sitator_tpu.util")]:
        ref_mod = importlib.import_module(ref)
        pkg_mod = importlib.import_module(pkg)
        for sym in pkg_mod.__all__:
            assert getattr(ref_mod, sym) is getattr(pkg_mod, sym), (ref, sym)


def test_shim_does_not_mutate_real_package(shim):
    import sitator
    assert sitator is not sitator_tpu
    assert not hasattr(sitator_tpu, "__sitator_tpu_compat__")
    assert not hasattr(sitator_tpu.landmark, "LandmarkAnalysis_shim")
    # the wrapper for sitator.landmark is a distinct module object
    import sitator.landmark
    assert sitator.landmark is not sitator_tpu.landmark
    assert (sitator.landmark.LandmarkAnalysis
            is sitator_tpu.landmark.LandmarkAnalysis)


def test_install_refuses_real_sitator_then_force():
    fake = type(sys)("sitator")
    sys.modules["sitator"] = fake
    try:
        with pytest.raises(RuntimeError, match="already imported"):
            compat.install()
        compat.install(force=True)
        import sitator
        assert getattr(sitator, "__sitator_tpu_compat__", False)
    finally:
        compat.uninstall()
        sys.modules.pop("sitator", None)


def test_uninstall_removes_namespace():
    compat.install()
    compat.uninstall()
    assert "sitator" not in sys.modules
    assert not any(m.startswith("sitator.") for m in sys.modules)
    # idempotent; and never deletes a non-shim sitator
    compat.uninstall()
    sys.modules["sitator"] = type(sys)("sitator")
    try:
        compat.uninstall()
        assert "sitator" in sys.modules
    finally:
        del sys.modules["sitator"]


def test_reference_script_end_to_end(shim):
    """A pipeline written purely against the reference API."""
    from sitator.landmark import LandmarkAnalysis
    from sitator.voronoi import VoronoiSiteGenerator
    from sitator.dynamics import JumpAnalysis, RemoveUnoccupiedSites
    from sitator import SiteNetwork

    from sitator_tpu.io import make_hopping_trajectory   # data feeder is ours

    md = make_hopping_trajectory(n_cells=2, a=4.0, n_ions=2, n_frames=150,
                                 jump_rate=0.02, seed=9)
    sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
    sn = VoronoiSiteGenerator(merge_tol=0.05).run(sn)
    st = LandmarkAnalysis(cutoff_midpoint=4.0, cutoff_steepness=3.0,
                          verbose=False).run(sn, md.traj)
    st = RemoveUnoccupiedSites().run(st)
    JumpAnalysis().run(st)
    assert st.site_network.n_sites > 0
    assert st.site_network.n_ij.shape == (st.site_network.n_sites,) * 2
    assert (st.traj >= -1).all()


def test_shim_in_fresh_subprocess():
    """The documented two-liner works in a clean interpreter."""
    code = (
        "import sitator_tpu.compat; sitator_tpu.compat.install()\n"
        "from sitator import SiteNetwork\n"
        "from sitator.landmark import LandmarkAnalysis\n"
        "print('COMPAT_OK', SiteNetwork.__module__)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert "COMPAT_OK sitator_tpu.core.sitenet" in out.stdout
