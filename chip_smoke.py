"""Bring-up smoke of the landmark engine on the GPU.

Drives the main path once, through the entry points a user calls, at the
flagship size (bench.py: 9261 static atoms, 739 mobile ions, 9261 landmark
polyhedra of 8 vertices, logistic_r2 cutoff), and checks it against the
float64 NumPy reference of bench.py, which shares no code with the package.

    python chip_smoke.py               # one GPU: phases 1-3
    python chip_smoke.py --devices 4   # four GPUs: phase 1 + the
                                       # frame-sharded streaming comparison

Phases (each prints one line; any failure raises, exit code non-zero):

1. device — JAX's devices must be GPUs; there is no CPU fallback.
2. kernel parity — 32 frames, 1024 centers: the Triton lv kernel against
   its plain twin and, on two frames, against the reference landmark
   vectors (max |dlv| <= 1e-5), then pass-2 labels/confidences
   against the reference: identical labels at f32; with the production
   bf16 similarity, identical labels wherever the reference's top-1 - top-2
   margin and |conf - threshold| both exceed 1e-2, and confidences within
   1e-2.
3. engine — StreamingLandmarkAnalysis at its defaults over 4 blocks of 1024
   frames from host memory (fit pass + stream pass), its recorded path,
   its labels on the first 32 frames, finite n_ij/occupancies, jump counts
   against a host recount of the spilled labels; LandmarkAnalysis on 64
   frames (landmark vectors against the reference) and JumpAnalysis on its
   result.  Prints pass-2 frames/s and first-block seconds (informative).

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}}``.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

TOL_LV = 1e-5
TOL_BF16 = 1e-2
N_FRAMES = 4 * 1024
P_HOP = 1e-3          # per-frame probability that an ion hops


def _line(phase, msg):
    print(f"phase {phase}: {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def flagship_network(fl):
    """The flagship as a SiteNetwork: static lattice + ions at their home
    sites, landmark nodes at the cage centers with their 8 vertices."""
    from sitator_tpu import SiteNetwork, Structure
    positions = np.concatenate([fl.static_ref, fl.site_pos[fl.home]])
    species = np.array([16] * fl.n_static + [3] * len(fl.home))
    s = Structure(positions, species, np.asarray(fl.cell, np.float64))
    sn = SiteNetwork(s, species == 16, species == 3)
    sn.centers = fl.site_pos
    sn.vertices = [fl.verts[i] for i in range(fl.n_static)]
    return sn


def trajectory(fl, static0, mobile0, n_frames, seed=11):
    """(n_frames, 10000, 3) f32 frames in host memory: the first frames are
    phase 2's; afterwards each of the first K - M ions toggles with
    probability ``P_HOP`` per frame between its home site and a vacant
    center site of its own (so jumps are frequent and countable, and no
    two ions ever share a site)."""
    rng = np.random.default_rng(seed)
    n0, M = mobile0.shape[:2]
    n = n_frames - n0
    n_alt = min(M, len(fl.center_sites) - M)
    hop = rng.random((n, M)) < P_HOP
    hop[:, n_alt:] = False
    away = np.cumsum(hop, axis=0) % 2 == 1
    # center i is ion i's home; center M + i is its private vacant site
    cur = np.where(away, np.arange(M) + M, np.arange(M))
    site = fl.center_sites[cur]
    traj = np.empty((n_frames, fl.n_static + M, 3), np.float32)
    traj[:n0, :fl.n_static] = static0
    traj[:n0, fl.n_static:] = mobile0
    traj[n0:, :fl.n_static] = fl.static_ref + 0.05 * rng.standard_normal(
        (n, fl.n_static, 3), dtype=np.float32)
    traj[n0:, fl.n_static:] = fl.site_pos[site] + 0.25 * rng.standard_normal(
        (n, M, 3), dtype=np.float32)
    return traj


def recount_jumps(labels, K):
    """Host recount of n_ij from a label matrix: a jump is a known label
    that differs from the ion's last known label (unknown frames persist)."""
    n_ij = np.zeros((K, K), np.int64)
    for col in labels.T:
        known = col[col >= 0]
        moved = known[1:] != known[:-1]
        np.add.at(n_ij, (known[:-1][moved], known[1:][moved]), 1)
    return n_ij


def phase_kernel(bench, fl, basis, static, mobile):
    import jax.numpy as jnp
    from sitator_tpu.ops.kernel_common import lv_impl
    from sitator_tpu.ops.landmark_mxu import (mxu_assign_blocks,
                                              permute_centers,
                                              tiled_landmark_vectors)
    from sitator_tpu.ops.pbc import kernel_cell

    check(lv_impl() == "triton", f"lv path on this device is {lv_impl()}")
    kc = kernel_cell(fl.cell)
    st, mo = jnp.asarray(static), jnp.asarray(mobile)
    args = (mo, st, basis["uidx"], basis["A"], basis["kill"], kc,
            basis["ref_u"], basis["anchors"])
    kw = dict(midpoint=bench.MIDPOINT, steepness=bench.STEEPNESS,
              cutoff_shape=bench.CUTOFF, preshift=basis["preshift"])
    lv_k = tiled_landmark_vectors(*args, impl="triton", **kw)
    lv_p = tiled_landmark_vectors(*args, impl="plain", **kw)
    dlv = float(jnp.max(jnp.abs(lv_k - lv_p)))
    _line(2, f"Triton lv vs plain twin: max|dlv| = {dlv:.3e} "
             f"(tolerance {TOL_LV:g})")
    check(dlv <= TOL_LV, "lv kernel disagrees with its plain twin")
    # and the kernel's landmark vectors (kd-tile column order) against
    # the float64 reference on two frames
    lv_k = np.asarray(lv_k[:2, :, :fl.n_static])
    del lv_p
    inv = np.argsort(basis["site_order"])
    dref = max(float(np.abs(lv_k[f][:, inv] - bench.reference_landmark_vectors(
        fl.cell, fl.verts, static[f], mobile[f])).max()) for f in range(2))
    _line(2, f"Triton lv vs float64 reference (2 frames): max|dlv| = "
             f"{dref:.3e} (tolerance {TOL_LV:g})")
    check(dref <= TOL_LV, "lv kernel disagrees with the reference")

    t0 = time.perf_counter()
    ref = [bench.reference_assign(fl.cell, fl.verts, static[f], mobile[f],
                                  fl.centers) for f in range(len(static))]
    lab_r = np.stack([r[0] for r in ref])
    conf_r = np.stack([r[1] for r in ref])
    margin = np.stack([r[2] for r in ref])
    _line(2, f"float64 reference on {len(static)} frames in "
             f"{time.perf_counter() - t0:.1f}s; "
             f"{(lab_r >= 0).mean():.3f} of ions assigned")

    cp = permute_centers(fl.centers, basis)
    out = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        lab, conf = mxu_assign_blocks(
            mo, st, basis, kc, cp, midpoint=bench.MIDPOINT,
            steepness=bench.STEEPNESS, threshold=bench.ASSIGN_THR,
            cutoff_shape=bench.CUTOFF, mxu_bf16=bf16)
        out[name] = (np.asarray(lab), np.asarray(conf))
    n_bad32 = int((out["f32"][0] != lab_r).sum())
    _line(2, f"f32 labels vs reference: {n_bad32} mismatches of "
             f"{lab_r.size} (tolerance 0)")
    check(n_bad32 == 0, "f32 labels differ from the reference")
    decided = (margin > TOL_BF16) & (np.abs(conf_r - bench.ASSIGN_THR)
                                     > TOL_BF16)
    lab16, conf16 = out["bf16"]
    n_bad16 = int(((lab16 != lab_r) & decided).sum())
    n_diff16 = int((lab16 != lab_r).sum())
    dconf = float(np.abs(conf16 - conf_r).max())
    _line(2, f"bf16 labels vs reference: {n_bad16} mismatches among "
             f"{int(decided.sum())} decided (margin and |conf-thr| > "
             f"{TOL_BF16:g}); {n_diff16} overall; max|dconf| = {dconf:.3e} "
             f"(tolerance {TOL_BF16:g})")
    check(n_bad16 == 0, "bf16 labels differ from the reference")
    check(dconf <= TOL_BF16, "bf16 confidences differ from the reference")
    return lab16, decided


def phase_engine(bench, fl, gpu, static, mobile, lab16, decided):
    from sitator_tpu.dynamics import JumpAnalysis
    from sitator_tpu.io.formats import ArrayTrajectory
    from sitator_tpu.landmark import (LandmarkAnalysis,
                                      StreamingLandmarkAnalysis)

    sn = flagship_network(fl)
    t0 = time.perf_counter()
    traj = trajectory(fl, static, mobile, N_FRAMES)
    _line(3, f"trajectory {traj.shape} f32 ({traj.nbytes / 1e6:.0f} MB) "
             f"in host memory, {time.perf_counter() - t0:.1f}s")
    phys = dict(cutoff_midpoint=bench.MIDPOINT,
                cutoff_steepness=bench.STEEPNESS, cutoff_shape=bench.CUTOFF)
    K = len(fl.centers)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "labels.npy")
        eng = StreamingLandmarkAnalysis(store_labels=path, verbose=False,
                                        **phys)
        t0 = time.perf_counter()
        c_fit = eng.fit_centers(sn, ArrayTrajectory(traj))
        check(len(c_fit) > 0 and np.isfinite(c_fit).all()
              and np.allclose(np.linalg.norm(c_fit, axis=1), 1.0,
                              atol=1e-3), "fit pass centers")
        _line(3, f"pass 1 (fit): {len(c_fit)} centers in "
                 f"{time.perf_counter() - t0:.1f}s")
        # first block alone: compiles the pass-2 programs
        t0 = time.perf_counter()
        eng.run(sn, ArrayTrajectory(traj[:1024]), centers=fl.centers)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = eng.run(sn, ArrayTrajectory(traj), centers=fl.centers)
        wall = time.perf_counter() - t0
        check(eng.kernel_path_ == "tiled:triton",
              f"engine ran {eng.kernel_path_}, not the GPU kernel")
        labels = np.load(path)
    n_ij = np.asarray(out.n_ij)
    occ = np.asarray(out.occupancies)
    check(np.isfinite(n_ij).all() and np.isfinite(occ).all(),
          "n_ij / occupancies not finite")
    n32 = len(lab16)
    bad = int(((labels[:n32] != lab16) & decided).sum())
    _line(3, f"engine path {eng.kernel_path_}; first {n32} frames vs "
             f"phase 2: {bad} mismatches among decided labels, "
             f"{int((labels[:n32] != lab16).sum())} overall")
    check(bad == 0, "engine labels differ from phase 2")
    recount = recount_jumps(labels, K)
    check(np.array_equal(n_ij, recount), "n_ij differs from host recount")
    _line(3, f"n_ij total {int(n_ij.sum())} jumps = host recount; "
             f"occupancy sum {occ.sum():.3f}")
    fps = N_FRAMES / wall
    _line(3, f"pass 2: {fps:.1f} frames/s over {N_FRAMES} frames "
             f"(wall {wall:.2f}s), first block {first_s:.1f}s "
             f"(compile included) on {gpu} — informative, not a claim")

    la = LandmarkAnalysis(verbose=False, **phys)
    st = la.run(sn, traj[:64])
    check(la.kernel_path_ == "tiled:triton",
          f"LandmarkAnalysis ran {la.kernel_path_}")
    lv_ref = bench.reference_landmark_vectors(
        fl.cell, fl.verts, traj[0, :fl.n_static], traj[0, fl.n_static:])
    lv_ref /= np.maximum(np.linalg.norm(lv_ref, axis=1, keepdims=True),
                         1e-12)
    dlv = float(np.abs(la.landmark_vectors[:len(lv_ref)] - lv_ref).max())
    _line(3, f"LandmarkAnalysis: {st.site_network.n_sites} sites from 64 "
             f"frames; landmark vectors vs reference max|d| = {dlv:.3e} "
             f"(tolerance {TOL_LV:g})")
    check(dlv <= TOL_LV, "landmark_vectors differ from the reference")
    ja = JumpAnalysis(verbose=False).run(st)
    n_ij_la = np.asarray(ja.site_network.n_ij)
    check(np.isfinite(n_ij_la).all(), "JumpAnalysis n_ij")
    _line(3, f"JumpAnalysis: {int(n_ij_la.sum())} jumps")


def phase_mesh(bench, fl, n_dev):
    """Frame-sharded streaming on an n-device mesh against a 1-device mesh
    in the same process: n_ij and occupancies must be bit-equal."""
    import jax
    from sitator_tpu.io.formats import ArrayTrajectory
    from sitator_tpu.landmark import StreamingLandmarkAnalysis
    from sitator_tpu.parallel.mesh import frame_mesh

    check(len(jax.devices()) >= n_dev,
          f"need {n_dev} GPUs, have {len(jax.devices())}")
    sn = flagship_network(fl)
    static, mobile = fl.frames(32, seed2=7)
    traj = trajectory(fl, static, mobile, 2 * 1024)
    outs = {}
    for n in (1, n_dev):
        eng = StreamingLandmarkAnalysis(
            cutoff_midpoint=bench.MIDPOINT, cutoff_steepness=bench.STEEPNESS,
            cutoff_shape=bench.CUTOFF, mesh=frame_mesh(n), verbose=False)
        t0 = time.perf_counter()
        outs[n] = eng.run(sn, ArrayTrajectory(traj), centers=fl.centers)
        check(eng.kernel_path_ == "tiled:triton",
              f"{n}-device engine ran {eng.kernel_path_}")
        _line(4, f"{n}-device mesh: {time.perf_counter() - t0:.1f}s "
                 "(compile included)")
    a, b = outs[1], outs[n_dev]
    check(np.array_equal(np.asarray(a.n_ij), np.asarray(b.n_ij)),
          "n_ij differs between meshes")
    check(np.array_equal(np.asarray(a.occupancies),
                         np.asarray(b.occupancies)),
          "occupancies differ between meshes")
    _line(4, f"{n_dev}-device n_ij ({int(np.asarray(a.n_ij).sum())} jumps) "
             "and occupancies bit-equal to the 1-device run")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the frame-sharded streaming "
                         "comparison across four GPUs")
    args = ap.parse_args()

    import jax
    import bench
    from sitator_tpu.util.compile_cache import enable_compile_cache
    enable_compile_cache()

    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"JAX found no GPU (platform {dev.platform!r})")
    gpu = bench.gpu_name_and_power_limit()
    print(f"gpu: {gpu}", flush=True)
    _line(1, f"{len(jax.devices())} x {dev.device_kind} ({dev.platform})")

    fl = bench.build_flagship()
    if args.devices == 4:
        phase_mesh(bench, fl, 4)
    else:
        from sitator_tpu.ops.landmark_mxu import prepare_engine_basis
        basis = prepare_engine_basis(
            fl.verts, np.ones_like(fl.verts, bool), fl.site_pos, fl.cell,
            midpoint=bench.MIDPOINT, steepness=bench.STEEPNESS,
            cutoff_shape=bench.CUTOFF, static_ref=fl.static_ref,
            drift_budget=1.0)
        check(basis is not None and basis["preshift"],
              "flagship basis did not take the tiled preshift route")
        static, mobile = fl.frames(32, seed2=7)
        lab16, decided = phase_kernel(bench, fl, basis, static, mobile)
        phase_engine(bench, fl, gpu, static, mobile, lab16, decided)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    sys.exit(main())
