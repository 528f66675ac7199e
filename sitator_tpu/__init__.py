"""sitator_tpu — accelerated unsupervised landmark analysis for MD trajectories.

A from-scratch JAX/Pallas rebuild of the capabilities of
``Linux-cpp-lisp/sitator`` (site analysis of solid-state ionic conductors:
Voronoi site seeding, landmark vectors, dot-product clustering, jump
statistics, site merging, diffusion pathways, SOAP site typing), redesigned
for accelerators: the hot loops are Pallas/XLA kernels over device-resident
frame blocks, frames shard across devices on a ``jax.sharding.Mesh``, and
per-site statistics reduce through XLA collectives.

The stable public interface mirrors the reference's L3 API (SURVEY.md §2):
engines are configured in their constructor and executed with ``.run()``,
taking and returning :class:`SiteNetwork` / :class:`SiteTrajectory`.
"""
from sitator_tpu.core.structure import Structure
from sitator_tpu.core.sitenet import SiteNetwork
from sitator_tpu.core.sitetraj import SiteTrajectory

__version__ = "0.7.0"

__all__ = ["Structure", "SiteNetwork", "SiteTrajectory", "__version__"]
