"""Repeatable validation (~8 min CPU; run: python tools/validate_preshift_streaming.py): StreamingLandmarkAnalysis with the tiled
preshift path (Pallas lv kernel in interpret mode, large cell where the bound ACTIVATES) must match
the dense-XLA streaming run label-for-label and stat-for-stat.  Uses the
analytic SC cage basis (as bench.py does) so the interpret-mode grid
stays tractable."""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import sys
import tempfile
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from sitator_tpu import SiteNetwork
from sitator_tpu.io import make_hopping_trajectory
from sitator_tpu.landmark import StreamingLandmarkAnalysis
from sitator_tpu.ops.landmark_mxu import prepare_engine_basis

N_C, A = 16, 4.0
md = make_hopping_trajectory(n_cells=N_C, a=A, n_ions=8, n_frames=750,
                             jump_rate=0.03, sigma_mobile=0.25, seed=17)
sn = SiteNetwork(md.structure, md.static_mask, md.mobile_mask)
# analytic SC cage basis: site = body center, verts = 8 surrounding atoms
grid = np.stack(np.meshgrid(*[np.arange(N_C)] * 3, indexing="ij"),
                axis=-1).reshape(-1, 3)
sn.centers = (grid + 0.5) * A

def idx(v):
    v = v % N_C
    return v[:, 0] * N_C * N_C + v[:, 1] * N_C + v[:, 2]

corners = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1],
                               indexing="ij"), -1).reshape(-1, 3)
sn.vertices = [np.array([idx((grid[i] + d)[None])[0] for d in corners],
                        np.int32) for i in range(len(grid))]
print("sites:", sn.n_sites, flush=True)

verts, vmask = sn.padded_vertices()
static_idx = np.flatnonzero(sn.static_mask)
basis = prepare_engine_basis(
    verts, vmask, sn.centers, sn.structure.cell,
    midpoint=3.5, steepness=5.0, cutoff_shape="logistic_r2",
    static_ref=sn.structure.positions[static_idx], drift_budget=1.0)
assert basis is not None and basis["preshift"], "preshift must activate"
print("preshift ACTIVE", flush=True)

def run(use_fused, tag):
    sla = StreamingLandmarkAnalysis(
        cutoff_midpoint=3.5, cutoff_steepness=5.0,
        cutoff_shape="logistic_r2", block_frames=125,
        use_fused=use_fused, interpret=use_fused, verbose=False,
        store_labels=os.path.join(tempfile.gettempdir(), f"val_{tag}.npy"))
    out = sla.run(sn, md.traj)
    labels = np.load(os.path.join(tempfile.gettempdir(), f"val_{tag}.npy"))
    print(f"{tag}: {out.n_sites} sites, {int(out.n_ij.sum())} jumps",
          flush=True)
    return out, labels

out_f, lab_f = run(True, "fused")
out_d, lab_d = run(False, "dense")
agree = float(np.mean(lab_f == lab_d))
print("label agreement:", agree, flush=True)
assert agree > 0.9999, agree
np.testing.assert_array_equal(np.asarray(out_f.n_ij),
                              np.asarray(out_d.n_ij))
np.testing.assert_allclose(np.asarray(out_f.occupancies),
                           np.asarray(out_d.occupancies), atol=1e-12)
print("VALIDATED: preshift streaming == dense streaming at 4096 sites")
