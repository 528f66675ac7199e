"""Device-mesh helpers for frame-axis SPMD.

The workload's natural parallel axis is the frame (time) axis — SURVEY.md
§3.10: landmark vectors are embarrassingly parallel over frames, and every
cross-device quantity is a tiny per-site reduction.  One 1-D mesh
covers DP/"CP"; the in-chip (mobile × site) plane is the degenerate TP axis
handled by the kernels themselves.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAME_AXIS = "frames"

__all__ = ["FRAME_AXIS", "frame_mesh", "frame_sharding", "replicated",
           "shard_frames", "shard_frames_local", "pad_frames",
           "shard_map_frames"]


def frame_mesh(n_devices=None, devices=None) -> Mesh:
    """1-D mesh over the frame axis (all visible devices by default)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading (frame) axis across the mesh."""
    return NamedSharding(mesh, P(FRAME_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_frames(arr, multiple):
    """Pad the leading axis to a multiple (repeating the last frame), so
    frame shards divide evenly.  Returns (padded, n_valid)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.broadcast_to(arr[-1:], (rem,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0), n


def shard_frames(arr, mesh: Mesh):
    """Device-put a host array with its leading axis sharded over the mesh.

    Single-process form: ``arr`` is the GLOBAL array.  On a multi-host pod
    (``jax.distributed.initialize`` + one process per host; the 1-D frame
    mesh spans all global devices and the per-site ``psum``s ride DCN
    between hosts) use :func:`shard_frames_local` instead — each process
    passes only its own frame slab.
    """
    return jax.device_put(arr, frame_sharding(mesh))


def shard_frames_local(local_arr, mesh: Mesh):
    """Multi-process-safe :func:`shard_frames`: each process contributes
    its LOCAL contiguous frame slab (global frame order = process order ×
    local order, the natural layout when each host reads its own slice of
    the trajectory).  Degenerates to :func:`shard_frames` in a single
    process, so the same feeding code runs on one chip, a virtual CPU
    mesh, or a pod.

    The slab-order guarantee requires the mesh's device sequence to be
    process-contiguous in ``process_index`` order; a topology-reordered
    mesh would scatter each host's contiguous frames onto non-contiguous
    global indices and silently scramble time order, so that is checked
    here.
    """
    procs = [d.process_index for d in mesh.devices.flat]
    if procs != sorted(procs):
        raise ValueError(
            "mesh devices are not process-contiguous in process_index "
            "order; build the frame mesh from jax.devices() (frame_mesh) "
            "rather than a topology-reordering helper, or device_put "
            "explicit per-device shards instead")
    return jax.make_array_from_process_local_data(
        frame_sharding(mesh), np.asarray(local_arr))


def shard_map_frames(fn, mesh: Mesh, n_frame_args: int, *args,
                     n_outputs: int = 2):
    """Run ``fn(*args)`` under ``shard_map`` on a 1-D frame mesh: the first
    ``n_frame_args`` arguments are frame-sharded, the rest replicated, and
    all outputs come back frame-sharded.  The single wrapper shared by the
    SPMD pipeline and the streaming engine (Pallas calls cannot be
    GSPMD-auto-partitioned; everything downstream of the returned arrays
    partitions automatically).  ``check_vma=False``: Pallas outputs carry
    no varying-mesh-axes info."""
    from jax import shard_map

    fs, rep = P(FRAME_AXIS), P()
    in_specs = (fs,) * n_frame_args + (rep,) * (len(args) - n_frame_args)
    return shard_map(fn, mesh=mesh, in_specs=in_specs,
                     out_specs=(fs,) * n_outputs, check_vma=False)(*args)
