"""Per-stage times of one pass-2 assign chunk at the flagship basis, and the
lv-stage A/B: the Pallas-Triton kernel against its plain-``jnp`` twin.

Flagship: bench.py's 10k-atom simple-cubic system (9261 static atoms, 739
ions, 9261 landmark polyhedra of 8 vertices, logistic_r2 cutoff), 1024
centers.  Stages, each its own jitted program on device-resident inputs,
timed on the host clock around ``block_until_ready``:

- ``lv``: tile-atom gather + preshift + distance core + log-space
  membership product + exp (Triton kernel, and the plain twin);
- ``sims``: the ``(B·M, SP) @ (SP, K)`` bf16 similarity product;
- ``argmax``: row norm, scale, argmax, threshold;
- ``jumps``: the jump scan of the block's labels.

The A/B alternates kernel and twin (T P P T ...) in one process, on the
lv stage alone and end to end through the ``StreamingLandmarkAnalysis``
pass-2 loop (``--engine-blocks`` blocks of 1024 frames from host memory).
Prints one JSON line; run on the GPU:  ``python tools/stage_split.py``.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def _time(fn, args, reps):
    out = fn(*args)
    jax_block(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax_block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return ts


def jax_block(x):
    import jax
    jax.tree.map(lambda a: a.block_until_ready(), x)


def _engine_ab(fl, centers, n_blocks, pairs):
    """Pass-2 frames/s of the streaming engine with the lv stage on the
    Triton kernel vs on its plain twin, alternating, same process.  The
    engine's jitted block step does not key on the lv choice, so every
    switch drops the compiled programs (``jax.clear_caches``) and runs
    one untimed warm-up before the timed run."""
    import jax
    import sitator_tpu.landmark.streaming as streaming
    import sitator_tpu.ops.landmark_mxu as lmxu
    from chip_smoke import flagship_network, trajectory
    from sitator_tpu.io.formats import ArrayTrajectory
    from sitator_tpu.landmark import StreamingLandmarkAnalysis

    sn = flagship_network(fl)
    static, mobile = fl.frames(32, seed2=7)
    traj = ArrayTrajectory(trajectory(fl, static, mobile, n_blocks * 1024))
    eng = StreamingLandmarkAnalysis(
        cutoff_midpoint=bench.MIDPOINT, cutoff_steepness=bench.STEEPNESS,
        cutoff_shape=bench.CUTOFF, verbose=False)
    fps = {"triton": [], "plain": []}
    paths = {}
    for i in range(pairs):
        order = ("triton", "plain") if i % 2 == 0 else ("plain", "triton")
        for impl in order:
            pick = (lambda interpret=False, impl=impl: impl)
            lmxu.lv_impl = streaming.lv_impl = pick
            jax.clear_caches()
            eng.run(sn, traj, centers=centers)          # compile + warm
            t0 = time.perf_counter()
            eng.run(sn, traj, centers=centers)
            fps[impl].append(len(traj) / (time.perf_counter() - t0))
            paths[impl] = eng.kernel_path_
    return {"engine_frames": len(traj), "engine_paths": paths,
            "engine_phase_times_last_s": {
                k: round(v, 4) for k, v in eng.phase_times_.items()},
            "engine_fps_triton": fps["triton"],
            "engine_fps_plain": fps["plain"],
            "engine_fps_triton_median": float(np.median(fps["triton"])),
            "engine_fps_plain_median": float(np.median(fps["plain"]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=32,
                    help="frames per timed chunk")
    ap.add_argument("--pairs", type=int, default=6,
                    help="alternating kernel/twin pairs")
    ap.add_argument("--engine-blocks", type=int, default=4,
                    help="1024-frame blocks per engine pass-2 run "
                         "(0 skips the engine A/B)")
    ap.add_argument("--chunk-gib", type=float, default=None,
                    help="override the frame-chunk byte budget of the "
                         "tiled path (GiB) for this run")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sitator_tpu.ops.jumps import _jump_stats
    from sitator_tpu.ops.landmark_mxu import (permute_centers,
                                              prepare_engine_basis,
                                              tiled_landmark_vectors)
    from sitator_tpu.ops.pbc import kernel_cell
    from sitator_tpu.util.compile_cache import enable_compile_cache

    import sitator_tpu.ops.landmark_mxu as lmxu
    if args.chunk_gib is not None:
        lmxu._CHUNK_BYTES = int(args.chunk_gib * (1 << 30))
    enable_compile_cache()
    dev = bench.require_gpu()
    gpu = bench.gpu_name_and_power_limit()
    print(f"# {gpu}", flush=True)

    fl = bench.build_flagship()
    cell, frames, centers, n_static = (fl.cell, fl.frames, fl.centers,
                                       fl.n_static)
    basis = prepare_engine_basis(
        fl.verts, np.ones_like(fl.verts, bool), fl.site_pos, cell,
        midpoint=bench.MIDPOINT, steepness=bench.STEEPNESS,
        cutoff_shape=bench.CUTOFF, static_ref=fl.static_ref,
        drift_budget=1.0)
    static, mobile = frames(args.frames, seed2=7)
    st = jnp.asarray(static)
    mo = jnp.asarray(mobile)
    kc = kernel_cell(cell)
    barr = (basis["uidx"], basis["A"], basis["kill"], kc, basis["ref_u"],
            basis["anchors"])
    kw = dict(midpoint=bench.MIDPOINT, steepness=bench.STEEPNESS,
              cutoff_shape=bench.CUTOFF, preshift=basis["preshift"])

    def lv_fn(impl, dtype):
        return jax.jit(lambda m, s, *b: tiled_landmark_vectors(
            m, s, *b, impl=impl, out_dtype=dtype, **kw))

    # --- compile + parity at f32 HIGHEST ------------------------------
    t0 = time.perf_counter()
    lv_t32 = lv_fn("triton", jnp.float32)(mo, st, *barr)
    jax_block(lv_t32)
    compile_s = time.perf_counter() - t0
    lv_p32 = lv_fn("plain", jnp.float32)(mo, st, *barr)
    dmax = float(jnp.max(jnp.abs(lv_t32 - lv_p32)))
    print(f"# triton lv compiled in {compile_s:.1f}s; max|dlv| vs plain "
          f"{dmax:.3e}", flush=True)
    del lv_t32, lv_p32

    # --- lv-stage A/B (production dtype bf16) -------------------------
    ft = lv_fn("triton", jnp.bfloat16)
    fp = lv_fn("plain", jnp.bfloat16)
    a = (mo, st) + barr
    times = {"triton": [], "plain": []}
    for i in range(args.pairs):
        order = ("triton", "plain") if i % 2 == 0 else ("plain", "triton")
        for name in order:
            f = ft if name == "triton" else fp
            times[name] += _time(f, a, 3)

    # --- the remaining stages of one chunk ----------------------------
    lv = ft(*a)
    ct = jnp.pad(jnp.asarray(permute_centers(centers, basis)).T,
                 ((0, lv.shape[-1] - n_static), (0, 0))).astype(jnp.bfloat16)

    @jax.jit
    def sims_fn(lv, ct):
        return jax.lax.dot_general(lv, ct, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    @jax.jit
    def argmax_fn(lv, sims):
        lvf = lv.astype(jnp.float32)
        inv = jax.lax.rsqrt(jnp.maximum(jnp.sum(lvf * lvf, -1), 1e-24))
        s = sims * inv[..., None]
        conf = jnp.max(s, -1)
        lab = jnp.argmax(s, -1).astype(jnp.int32)
        return jnp.where(conf >= bench.ASSIGN_THR, lab, -1), conf

    jumps_fn = jax.jit(lambda lab: _jump_stats(lab, len(centers)))
    t_sims = _time(sims_fn, (lv, ct), 10)
    sims = sims_fn(lv, ct)
    t_arg = _time(argmax_fn, (lv, sims), 10)
    lab, _ = argmax_fn(lv, sims)
    t_jump = _time(jumps_fn, (lab,), 10)

    engine = (_engine_ab(fl, centers, args.engine_blocks, args.pairs)
              if args.engine_blocks else {})

    F = args.frames

    def us(ts):
        return 1e6 * float(np.median(ts)) / F

    res = {
        "what": "pass-2 assign chunk stage split, us per frame (median)",
        "chunk_bytes": lmxu._CHUNK_BYTES,
        "gpu": gpu, "device_kind": dev.device_kind,
        "frames_per_chunk": F, "s_tile": basis["s_tile"],
        "n_st": basis["n_st"], "UP": basis["UP"],
        "preshift": basis["preshift"],
        "lv_parity_max_abs_f32_highest": dmax,
        "lv_triton_us": us(times["triton"]),
        "lv_plain_us": us(times["plain"]),
        "lv_triton_all_s": times["triton"], "lv_plain_all_s": times["plain"],
        "sims_us": us(t_sims), "argmax_us": us(t_arg),
        "jumps_us": us(t_jump),
        **engine,
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
