"""Fifth walkthrough: multi-device frame-parallel analysis.

The workload's natural parallel axis is the frame axis (SURVEY.md §3.10):
landmark vectors are embarrassingly parallel over frames, and the only
cross-device traffic is tiny per-site reductions (`psum`).  One 1-D
`jax.sharding.Mesh` therefore covers the whole scaling story — on a host
with several GPUs the same code spreads over all of them.

This script demonstrates it WITHOUT accelerator hardware by forcing 8 virtual CPU
devices (the same trick the test suite uses), then shows:

1. `StreamingLandmarkAnalysis(mesh=frame_mesh())` — the out-of-core engine
   sharding every block over all devices;
2. bit-exactness: the 8-device run reproduces the single-device run label
   for label and count for count (masked padding + psum-only stats make
   the math invariant to the device count).

Run:  python examples/multichip_mesh.py        (no env vars needed —
the script pins the backend itself, before jax is imported)
"""
import os
import tempfile

# must happen BEFORE jax import: 8 virtual CPU devices
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

from _common import _ensure_importable  # noqa: E402

_ensure_importable()

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")
assert len(jax.devices()) == 8, jax.devices()

from sitator_tpu import SiteNetwork  # noqa: E402
from sitator_tpu.io import NpyTrajectory, make_hopping_trajectory  # noqa: E402
from sitator_tpu.landmark import StreamingLandmarkAnalysis  # noqa: E402
from sitator_tpu.parallel import frame_mesh  # noqa: E402
from sitator_tpu.voronoi import VoronoiSiteGenerator  # noqa: E402

print(f"devices: {len(jax.devices())} x {jax.devices()[0].platform}")

tmp = tempfile.mkdtemp(prefix="sitator_mesh_")
md = make_hopping_trajectory(n_cells=3, a=4.0, n_ions=4, n_frames=4096,
                             jump_rate=0.02, seed=9)
traj_path = os.path.join(tmp, "traj.npy")
np.save(traj_path, md.traj)

sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
seeds = VoronoiSiteGenerator(verbose=False).run(sn)


def stream(mesh, tag):
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=4.0, cutoff_steepness=3.0, block_frames=512,
        mesh=mesh, store_labels=os.path.join(tmp, f"labels_{tag}.npy"),
        verbose=False)
    out = sla.run(seeds, NpyTrajectory(traj_path))
    labels = np.load(os.path.join(tmp, f"labels_{tag}.npy"))
    return out, labels


out1, labels1 = stream(None, "1dev")
print(f"single device : {out1.n_sites} sites, {int(out1.n_ij.sum())} jumps")

mesh = frame_mesh()          # all 8 virtual devices, frame axis sharded
out8, labels8 = stream(mesh, "8dev")
print(f"8-device mesh  : {out8.n_sites} sites, {int(out8.n_ij.sum())} jumps")

assert np.array_equal(labels1, labels8), "labels must be bit-identical"
assert np.array_equal(np.asarray(out1.n_ij), np.asarray(out8.n_ij))
assert np.allclose(np.asarray(out1.occupancies),
                   np.asarray(out8.occupancies))
print("8-device run is bit-identical to the single-device run.")
print("On a multi-GPU host the identical code runs with JAX_PLATFORMS unset —")
print("frame_mesh() picks up the real devices.")
