"""Benchmark: landmark + assignment + jump detection throughput (frames/sec)
at the flagship scale — 10k atoms (9261 static simple-cubic lattice, 739
mobile ions), a 9261-landmark basis (8 vertices each), 1024 site centers —
on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "spread",
"n_reps", ...} — value is the MEDIAN of n_reps in-process repeats and spread
is [min, max]; the line names the device and the card's power limit.
vs_baseline is measured against a vectorized-NumPy implementation of the
reference algorithm (sitator's Cython loop is single-core; vectorized NumPy
with multithreaded BLAS is a generous stand-in) on the same config.

There is no CPU mode: without a GPU the script exits non-zero.
"""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

N_CELLS = 21          # 21^3 = 9261 static atoms
A_LAT = 4.0
N_IONS = 739          # 9261 + 739 = 10000 atoms
K_CENTERS = 1024
BLOCK = 32            # frames per analysis block
N_BLOCKS = 8          # blocks per timed dispatch (scan-batched)
MIDPOINT, STEEPNESS, ASSIGN_THR = 4.0, 3.0, 0.35
# both sides use the production cutoff (slope-matched logistic in d^2 —
# same smooth-switch physics, no sqrt); comparison is apples-to-apples
CUTOFF = "logistic_r2"


def _grid():
    return np.stack(np.meshgrid(*[np.arange(N_CELLS)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3)


def build_flagship(seed=0):
    """The flagship system as a namespace: ``cell``, ``verts (S, 8)``,
    ``frames``, ``centers (K, S)``, ``n_static``, ``site_pos (S, 3)`` (the
    landmark nodes, for the kd tiling), ``static_ref (N, 3)`` (the ideal
    lattice) and ``home (M,)`` (each ion's home site).

    ``frames(n, seed2)`` returns ``(static, mobile)`` f32 position blocks
    (thermal noise about the lattice and about each ion's home site).
    ``centers`` are unit landmark vectors of ions sitting exactly on K
    sites — the 739 home sites first, in ion order — computed by the
    float64 reference, so assignments are meaningful (a random center
    would sit below the assignment threshold for every ion)."""
    rng = np.random.default_rng(seed)
    grid = _grid()
    n_static = len(grid)
    host = grid * A_LAT
    cell = np.eye(3, dtype=np.float32) * (N_CELLS * A_LAT)
    # analytic SC cage vertices (what VoronoiSiteGenerator produces, built
    # directly so the bench isolates the hot path)
    verts = np.zeros((n_static, 8), np.int32)
    k = 0
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                gi = (grid[:, 0] + di) % N_CELLS
                gj = (grid[:, 1] + dj) % N_CELLS
                gk = (grid[:, 2] + dk) % N_CELLS
                verts[:, k] = (gi * N_CELLS + gj) * N_CELLS + gk
                k += 1
    sites = (grid + 0.5) * A_LAT
    occ = rng.choice(n_static, size=N_IONS, replace=False)

    def frames(n, seed2):
        r = np.random.default_rng(seed2)
        static = host[None] + r.normal(scale=0.05, size=(n, n_static, 3))
        mobile = sites[occ][None] + r.normal(scale=0.25, size=(n, N_IONS, 3))
        return static.astype(np.float32), mobile.astype(np.float32)

    rest = np.setdiff1d(np.arange(n_static), occ)
    csites = np.concatenate(
        [occ, rng.choice(rest, K_CENTERS - N_IONS, replace=False)])
    lv = reference_landmark_vectors(cell, verts, host, sites[csites])
    centers = (lv / np.linalg.norm(lv, axis=1, keepdims=True)
               ).astype(np.float32)
    return SimpleNamespace(cell=cell, verts=verts, frames=frames,
                           centers=centers, n_static=n_static,
                           site_pos=sites, static_ref=host, home=occ,
                           center_sites=csites)


def build_system(seed=0):
    """``(cell, verts, frames, centers, n_static)`` of
    :func:`build_flagship`."""
    f = build_flagship(seed)
    return f.cell, f.verts, f.frames, f.centers, f.n_static


def reference_landmark_vectors(cell, verts, static, mobile, site_chunk=256,
                               dtype=np.float64):
    """Reference algorithm for one frame, vectorized NumPy (site-chunked,
    chunks spread over a thread pool — NumPy releases the GIL in these
    ufuncs): per-site gather of vertex positions, minimum image,
    logistic_r2 cutoff, product over vertices.  ``static (N, 3)``,
    ``mobile (M, 3)`` → ``(M, S)`` raw landmark vectors.  Independent of
    the package."""
    from concurrent.futures import ThreadPoolExecutor

    cell = np.asarray(cell, dtype)
    cell_inv = np.linalg.inv(cell)
    static = np.asarray(static, dtype)
    mobile = np.asarray(mobile, dtype)
    S = len(verts)
    k2 = STEEPNESS / (2.0 * MIDPOINT)
    lv = np.empty((len(mobile), S), dtype)

    def fill(lo):
        vp = static[verts[lo:lo + site_chunk]]           # (Sc, 8, 3)
        diff = mobile[:, None, None, :] - vp[None]       # (M, Sc, 8, 3)
        df = diff @ cell_inv
        df -= np.round(df)
        d2 = np.sum((df @ cell) ** 2, axis=-1)           # (M, Sc, 8)
        lv[:, lo:lo + site_chunk] = np.exp(np.sum(
            -np.logaddexp(0.0, k2 * (d2 - MIDPOINT ** 2)), axis=-1))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(fill, range(0, S, site_chunk)))
    return lv


def reference_assign(cell, verts, static, mobile, centers, dtype=np.float64):
    """Reference labels for one frame: normalize, max cosine, threshold.
    Returns (labels, confs, margin) — margin is the top-1 − top-2 cosine,
    the distance of each decision from a tie."""
    lv = reference_landmark_vectors(cell, verts, static, mobile, dtype=dtype)
    lv /= np.maximum(np.linalg.norm(lv, axis=1, keepdims=True), 1e-12)
    sims = lv @ np.asarray(centers, dtype).T                # (M, K)
    top2 = np.sort(sims, axis=1)[:, -2:]
    lab = sims.argmax(1)
    conf = sims.max(1)
    lab[conf < ASSIGN_THR] = -1
    return lab, conf, top2[:, 1] - top2[:, 0]


def cpu_reference_fps(cell, verts, frames, centers, n_frames=10):
    """Frames/sec of the f32 NumPy reference on this host's CPU."""
    static, mobile = frames(n_frames, seed2=123)
    t0 = time.perf_counter()
    for f in range(n_frames):
        reference_assign(cell, verts, static[f], mobile[f], centers,
                         dtype=np.float32)
    return n_frames / (time.perf_counter() - t0)


def kernel_flops_per_frame(basis):
    """Host-side FLOP count of the tiled path at this basis: matmuls at
    2·M·N·K, the elementwise distance+cutoff core at 12 FLOP per (ion,
    unique-atom) pair (3 subs + 3 muls + 2 adds for d², ~4 for the
    softplus core; exp/log counted as 1)."""
    n_st, UP, s_tile = basis["n_st"], basis["UP"], basis["s_tile"]
    SP = n_st * s_tile
    fl_A = 2 * N_IONS * UP * s_tile * n_st      # log-space membership matmul
    fl_sims = 2 * N_IONS * SP * K_CENTERS       # similarity matmul (bf16)
    fl_pairs = 12 * N_IONS * UP * n_st          # distance + cutoff core
    fl_norm = 2 * N_IONS * SP                   # self-norm
    return fl_A + fl_sims + fl_pairs + fl_norm


def gpu_name_and_power_limit():
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0] if out else out


def require_gpu():
    """The device this process measures; exits non-zero unless it is a
    GPU (no CPU fallback: a CPU number is never a device number)."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: JAX found no GPU (platform {dev.platform!r}); "
                 "refusing to measure")
    return dev


def device_fps(cell, verts, frames, centers, n_static, mode="tiled"):
    """Throughput of the full landmark+assign+jump step on device.

    mode 'tiled' is the production path (unique-atom tiled lv stage —
    the Triton kernel on a GPU — plus XLA assign); 'gather' the per-vertex
    gather path; 'dense' the dense log-matmul reference formulation.
    Timing is scan-batched — one dispatch covers N_BLOCKS blocks and
    returns a scalar, so dispatch latency cannot pollute the measurement.
    """
    import jax
    import jax.numpy as jnp
    from sitator_tpu.ops import landmark as lmops
    from sitator_tpu.ops.jumps import _jump_stats_parallel
    from sitator_tpu.ops.landmark_gather import gather_assign_blocks
    from sitator_tpu.ops.landmark_mxu import (choose_s_tile,
                                              mxu_assign_blocks,
                                              permute_centers,
                                              prepare_mxu_basis)

    cell_j = jnp.asarray(cell)
    cell_inv = jnp.asarray(np.linalg.inv(cell).astype(np.float32))
    cell_diag = jnp.asarray(np.diag(cell).astype(np.float32))
    vmask = jnp.ones_like(verts, dtype=bool)
    active = jnp.ones(K_CENTERS, bool)

    basis = None
    centers_arg = jnp.asarray(centers)
    if mode == "tiled":
        grid = _grid()
        site_pos = (grid + 0.5) * A_LAT
        s_tile = choose_s_tile(verts, np.ones_like(verts, bool), site_pos,
                               cell)
        basis = prepare_mxu_basis(verts, np.ones_like(verts, bool),
                                  site_pos, cell, s_tile=s_tile,
                                  static_ref=grid * A_LAT,
                                  midpoint=MIDPOINT, steepness=STEEPNESS,
                                  cutoff_shape=CUTOFF)
        centers_arg = jnp.asarray(permute_centers(centers, basis))
    A = (lmops.vertex_membership_matrix(verts, np.ones_like(verts, bool),
                                        n_static)
         if mode == "dense" else None)

    @jax.jit
    def step(static_blocks, mobile_blocks, verts_j, centers_j, A):
        def body(carry, xs):
            static, mobile = xs
            if mode == "tiled":
                labels, confs = mxu_assign_blocks(
                    mobile, static, basis, cell_diag, centers_j,
                    midpoint=MIDPOINT, steepness=STEEPNESS,
                    threshold=ASSIGN_THR, cutoff_shape=CUTOFF)
            elif mode == "gather":
                labels, confs = gather_assign_blocks(
                    mobile, static, verts_j, vmask, cell_diag, centers_j,
                    midpoint=MIDPOINT, steepness=STEEPNESS,
                    threshold=ASSIGN_THR, cutoff_shape=CUTOFF)
            else:
                lv = lmops.landmark_vectors(
                    mobile, static, A, cell_j, cell_inv, MIDPOINT, STEEPNESS,
                    matmul_dtype=jnp.bfloat16, cutoff_shape=CUTOFF)
                lv_n, _ = lmops.normalize_landmark_vectors(lv)
                labels, confs = lmops.assign_to_centers(
                    lv_n, centers_j, active, ASSIGN_THR,
                    matmul_dtype=jnp.bfloat16)
            stats = _jump_stats_parallel(labels, K_CENTERS)
            return carry + stats["n_ij"].sum() + labels.sum(), None

        total, _ = jax.lax.scan(body, jnp.int32(0),
                                (static_blocks, mobile_blocks))
        return total

    static, mobile = frames(N_BLOCKS * BLOCK, seed2=7)
    sb = jnp.asarray(static.reshape(N_BLOCKS, BLOCK, n_static, 3))
    mb = jnp.asarray(mobile.reshape(N_BLOCKS, BLOCK, N_IONS, 3))
    args = (sb, mb, jnp.asarray(verts), centers_arg, A)

    t0 = time.perf_counter()
    np.asarray(step(*args))                    # compile + warm (full sync)
    compile_s = time.perf_counter() - t0
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(step(*args))                # scalar transfer == sync
        reps.append(N_BLOCKS * BLOCK / (time.perf_counter() - t0))
    return reps, basis, compile_s


def main():
    from sitator_tpu.util.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = require_gpu()
    import jax
    gpu = gpu_name_and_power_limit()
    mode = "tiled"
    cell, verts, frames, centers, n_static = build_system()
    reps, basis, compile_s = device_fps(cell, verts, frames, centers,
                                        n_static, mode=mode)
    fps = float(np.median(reps))
    ref = cpu_reference_fps(cell, verts, frames, centers, n_frames=10)
    flops = kernel_flops_per_frame(basis) if basis is not None else None
    print(json.dumps({
        "metric": "frames_per_sec_landmark_assign_jump_10k_atoms_1gpu",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / ref, 1),
        "spread": [round(min(reps), 2), round(max(reps), 2)],
        "n_reps": len(reps),
        "gflop_per_frame": (round(flops / 1e9, 2)
                            if flops is not None else None),
        "compile_s": round(compile_s, 1),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu": gpu,
        "mode": mode,
        "s_tile": basis["s_tile"] if basis is not None else None,
    }))


if __name__ == "__main__":
    main()
