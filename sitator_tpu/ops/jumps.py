"""On-device jump statistics (hot loop #3).

Device redesign of the reference ``sitator/dynamics/JumpAnalysis.py``
frame loop (SURVEY.md §3.4, §4.3): the per-ion "last known site" carry runs
as a single ``lax.scan`` over frames with vectorized per-ion state, and every
per-event tally (hop counts ``n_ij``, residence sums, jump-lag sums) is a
masked scatter-add into dense ``(S+1, S+1)`` accumulators carried through the
scan — no Python loop, no host sync, shardable over the frame axis with a
final ``psum`` (SURVEY.md §3.10).

Unknown-site frames (``-1``) follow the reference's default policy
(``unknown_policy='persist'``): they neither emit jumps nor advance
residence, and an ion's previous site persists across unknown gaps.  The
alternative ``'break'`` policy (SURVEY.md §3.4 ⚠) forgets the previous
site at an unknown frame — a later assignment starts a fresh residence
and records no jump across the gap.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["jump_stats", "jump_stats_exact", "jump_stats_parallel",
           "JumpStats"]


class JumpStats(dict):
    """n_ij (S,S), lag_sum (S,S), res_sum (S,), res_cnt (S,), occ_counts (S,),
    last_sites (M,), last_res (M,)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


def jump_stats(traj, n_sites, init_last=None, init_res=None,
               unknown_policy="persist"):
    """Scan a ``(F, M)`` site trajectory into dense jump statistics.

    ``init_last``/``init_res`` allow chaining across trajectory blocks (the
    streaming pipeline feeds the carry of one block into the next).
    ``unknown_policy``: 'persist' (default — unknown frames keep the
    previous site) or 'break' (an unknown frame forgets it: no jump is
    recorded across the gap and the next assignment starts fresh).

    Returns a :class:`JumpStats` whose matrices use true site indices
    (row/col ``n_sites`` is the internal dummy slot, already stripped).
    """
    return JumpStats(_jump_stats(traj, n_sites, init_last, init_res,
                                 unknown_policy=unknown_policy))


@partial(jax.jit, static_argnames=("n_sites", "unknown_policy"))
def _jump_stats(traj, n_sites, init_last=None, init_res=None,
                unknown_policy="persist"):
    if unknown_policy not in ("persist", "break"):
        raise ValueError("unknown_policy must be 'persist' or 'break'")
    F, M = traj.shape
    S = n_sites
    if init_last is None:
        init_last = jnp.full((M,), -1, dtype=jnp.int32)
    if init_res is None:
        init_res = jnp.zeros((M,), dtype=jnp.int32)

    n_ij0 = jnp.zeros((S + 1, S + 1), dtype=jnp.int32)
    lag0 = jnp.zeros((S + 1, S + 1), dtype=jnp.int32)
    res_sum0 = jnp.zeros((S + 1,), dtype=jnp.int32)
    res_cnt0 = jnp.zeros((S + 1,), dtype=jnp.int32)

    def body(carry, s_f):
        last, res, n_ij, lag, res_sum, res_cnt = carry
        known = s_f >= 0
        have_last = last >= 0
        jump = known & have_last & (s_f != last)
        stay = known & have_last & (s_f == last)
        first = known & ~have_last

        # dummy slot S for non-jumping ions keeps shapes static
        i_from = jnp.where(jump, last, S)
        i_to = jnp.where(jump, s_f, S)
        one = jump.astype(jnp.int32)
        n_ij = n_ij.at[i_from, i_to].add(one)
        lag = lag.at[i_from, i_to].add(jnp.where(jump, res, 0))
        res_sum = res_sum.at[i_from].add(jnp.where(jump, res, 0))
        res_cnt = res_cnt.at[i_from].add(one)

        res = jnp.where(jump | first, 1, jnp.where(stay, res + 1, res))
        if unknown_policy == "break":
            last = jnp.where(known, s_f, -1)
            res = jnp.where(known, res, 0)  # carry is void after a gap
        else:
            last = jnp.where(known, s_f, last)
        return (last, res, n_ij, lag, res_sum, res_cnt), None

    (last, res, n_ij, lag, res_sum, res_cnt), _ = jax.lax.scan(
        body, (init_last, init_res, n_ij0, lag0, res_sum0, res_cnt0),
        traj.astype(jnp.int32))

    # occupancy tallies: frames spent at each site (independent of the scan)
    occ = jnp.zeros((S + 1,), dtype=jnp.int32)
    clipped = jnp.where(traj >= 0, traj, S)
    occ = occ.at[clipped.ravel()].add(1)

    return dict(
        n_ij=n_ij[:S, :S],
        lag_sum=lag[:S, :S],
        res_sum=res_sum[:S],
        res_cnt=res_cnt[:S],
        occ_counts=occ[:S],
        last_sites=last,
        last_res=res,
    )


def _jump_stats_block_int64(traj, S, last, res, unknown_policy):
    """Pure-NumPy int64 scan over one frame block — the exact fallback for
    blocks whose carried residences could wrap an int32 cell (vectorized
    over ions; the frame loop is Python, used only for the rare hazardous
    block)."""
    import numpy as np

    F, M = traj.shape
    n_ij = np.zeros((S + 1, S + 1), np.int64)
    lag = np.zeros((S + 1, S + 1), np.int64)
    res_sum = np.zeros(S + 1, np.int64)
    res_cnt = np.zeros(S + 1, np.int64)
    occ = np.zeros(S + 1, np.int64)
    one = np.ones(M, np.int64)
    for f in range(F):
        s_f = traj[f].astype(np.int64)
        known = s_f >= 0
        have = last >= 0
        jump = known & have & (s_f != last)
        stay = known & have & (s_f == last)
        first = known & ~have
        i_from = np.where(jump, last, S)
        i_to = np.where(jump, s_f, S)
        jv = jump.astype(np.int64)
        np.add.at(n_ij, (i_from, i_to), jv)
        np.add.at(lag, (i_from, i_to), np.where(jump, res, 0))
        np.add.at(res_sum, i_from, np.where(jump, res, 0))
        np.add.at(res_cnt, i_from, jv)
        np.add.at(occ, np.where(known, s_f, S), one)
        res = np.where(jump | first, 1, np.where(stay, res + 1, res))
        if unknown_policy == "break":
            last = np.where(known, s_f, -1)
            res = np.where(known, res, 0)
        else:
            last = np.where(known, s_f, last)
    return dict(n_ij=n_ij[:S, :S], lag_sum=lag[:S, :S],
                res_sum=res_sum[:S], res_cnt=res_cnt[:S],
                occ_counts=occ[:S]), last, res


def jump_stats_exact(traj, n_sites, init_last=None, init_res=None,
                     unknown_policy="persist", block_frames=None):
    """:func:`jump_stats` with int64-exact accumulation at any length.

    The device accumulators are int32 for speed; a residence-weighted sum
    (``lag_sum``/``res_sum``) or ``occ_counts`` can silently wrap once the
    frame×ion volume approaches 2^31 events.  This wrapper runs the SAME
    scan in frame blocks sized so each block's event tallies stay ≤ 2^26
    (the streaming engine's epoch bound, ``landmark/streaming.py``), chains
    the (last, res) carry across blocks — exact for either
    ``unknown_policy`` because the carry is the scan's own state — and sums
    the per-block outputs into host int64.  Output statistics are numpy
    int64; ``last_sites``/``last_res`` come from the final block's carry
    (held in int64 on the host, so even a >int32 single residence chains
    exactly).

    In-block wrap safety is guaranteed by a SOUND pre-block bound: the
    residences ion ``i`` can close inside a block total at most
    ``carry_res_i + 2·block_frames`` (its open residence plus disjoint
    in-block runs), so any single accumulator cell's in-block delta is ≤
    ``Σ_i carry_res_i + 2·M·block_frames``.  Blocks where that bound
    reaches int32 range — pathological carried residences, e.g. many ions
    idle for millions of frames finally jumping — are recomputed with a
    pure-NumPy int64 scan instead of the device scan.  No silent wrap at
    any frame count that fits in RAM.
    """
    import numpy as np

    traj = np.asarray(traj)
    F, M = traj.shape
    if block_frames is None:
        block_frames = max(1, (1 << 26) // max(1, M))
    last = (np.full((M,), -1, np.int64) if init_last is None
            else np.asarray(init_last).astype(np.int64))
    res = (np.zeros((M,), np.int64) if init_res is None
           else np.asarray(init_res).astype(np.int64))
    host = None
    for lo in range(0, F, block_frames):
        blk_traj = traj[lo:lo + block_frames]
        # sound per-cell wrap bound for this block (see docstring)
        bound = int(np.maximum(res, 0).sum()) \
            + 2 * M * int(len(blk_traj))
        if bound >= (1 << 31):
            dev, last, res = _jump_stats_block_int64(
                blk_traj, n_sites, last, res, unknown_policy)
        else:
            blk = jump_stats(jnp.asarray(blk_traj), n_sites,
                             init_last=jnp.asarray(last, jnp.int32),
                             init_res=jnp.asarray(res, jnp.int32),
                             unknown_policy=unknown_policy)
            last = np.asarray(blk["last_sites"]).astype(np.int64)
            res = np.asarray(blk["last_res"]).astype(np.int64)
            dev = {k: np.asarray(v) for k, v in blk.items()
                   if k not in ("last_sites", "last_res")}
        if host is None:
            host = {k: v.astype(np.int64) for k, v in dev.items()}
        else:
            for k, v in dev.items():
                host[k] += v
    if host is None:  # F == 0: empty statistics, carry passed through
        S = n_sites
        host = dict(n_ij=np.zeros((S, S), np.int64),
                    lag_sum=np.zeros((S, S), np.int64),
                    res_sum=np.zeros(S, np.int64),
                    res_cnt=np.zeros(S, np.int64),
                    occ_counts=np.zeros(S, np.int64))
    host["last_sites"] = last.astype(np.int32)
    host["last_res"] = res
    return JumpStats(host)


def jump_stats_parallel(traj, n_sites, unknown_policy="persist"):
    """Order-dependent jump statistics WITHOUT a sequential frame scan —
    exact, and partitionable over a frame-sharded mesh (SURVEY.md §6.7).

    The "last known site" carry is re-expressed as associative prefix ops:

    - ``filled`` — forward-fill of known sites (``associative_scan``);
    - ``K`` — running count of known frames (``cumsum``);
    - run starts marked where ``filled`` changes; the known-frame count at
      the most recent run start is a ``cummax`` (run starts have
      monotonically increasing ``K``), so the residence closed by a jump at
      frame ``f`` is ``K[f-1] - cummax_start_K[f-1]``.

    XLA partitions prefix scans across shards with log-depth collectives,
    so under ``pjit`` on a frame-sharded array this runs without any
    host-side stitching.  Returns the same :class:`JumpStats` as
    :func:`jump_stats` (bitwise-identical statistics for either
    ``unknown_policy``).
    """
    return JumpStats(_jump_stats_parallel(traj, n_sites,
                                          unknown_policy=unknown_policy))


@partial(jax.jit, static_argnames=("n_sites", "unknown_policy"))
def _jump_stats_parallel(traj, n_sites, unknown_policy="persist"):
    if unknown_policy not in ("persist", "break"):
        raise ValueError("unknown_policy must be 'persist' or 'break'")
    traj = traj.astype(jnp.int32)
    F, M = traj.shape
    S = n_sites
    known = traj >= 0
    # occupancy tallies are policy-independent (raw labels, dummy slot S)
    occ = jnp.zeros((S + 1,), jnp.int32).at[
        jnp.where(known, traj, S).ravel()].add(1)

    if unknown_policy == "break":
        # the break policy is LOCAL: a jump needs two consecutive known
        # frames; a run ends at any unknown frame or site change
        prev_raw = jnp.concatenate(
            [jnp.full((1, M), -1, jnp.int32), traj[:-1]], axis=0)
        jump = known & (prev_raw >= 0) & (traj != prev_raw)
        start = known & ((prev_raw < 0) | (traj != prev_raw))
        idx = jnp.broadcast_to(jnp.arange(F, dtype=jnp.int32)[:, None],
                               (F, M))
        start_idx = jnp.where(start, idx, -1)
        run_base = jax.lax.cummax(start_idx, axis=0)   # frame of run start
        prev_base = jnp.concatenate(
            [jnp.full((1, M), -1, jnp.int32), run_base[:-1]], axis=0)
        # residence closed by a jump at frame f = length of the run that
        # ended at f-1
        res = (idx - 1) - prev_base + 1

        i_from = jnp.where(jump, prev_raw, S).ravel()
        i_to = jnp.where(jump, traj, S).ravel()
        one = jump.astype(jnp.int32).ravel()
        resv = jnp.where(jump, res, 0).ravel()

        n_ij = jnp.zeros((S + 1, S + 1), jnp.int32).at[
            i_from, i_to].add(one)
        lag = jnp.zeros((S + 1, S + 1), jnp.int32).at[
            i_from, i_to].add(resv)
        res_sum = jnp.zeros((S + 1,), jnp.int32).at[i_from].add(resv)
        res_cnt = jnp.zeros((S + 1,), jnp.int32).at[i_from].add(one)
        last_known = known[-1]
        return dict(
            n_ij=n_ij[:S, :S],
            lag_sum=lag[:S, :S],
            res_sum=res_sum[:S],
            res_cnt=res_cnt[:S],
            occ_counts=occ[:S],
            last_sites=jnp.where(last_known, traj[-1], -1),
            last_res=jnp.where(last_known,
                               (F - 1) - run_base[-1] + 1, 0),
        )

    filled = jax.lax.associative_scan(
        lambda a, b: jnp.where(b >= 0, b, a), traj, axis=0)
    K = jnp.cumsum(known.astype(jnp.int32), axis=0)           # inclusive

    prev = jnp.concatenate(
        [jnp.full((1, M), -1, jnp.int32), filled[:-1]], axis=0)
    start = known & (filled != prev)
    # K-count just before each run started; cummax == forward-fill because
    # run starts carry nondecreasing K
    startK = jnp.where(start, K - 1, -1)
    run_base = jax.lax.cummax(startK, axis=0)
    prev_base = jnp.concatenate(
        [jnp.full((1, M), -1, jnp.int32), run_base[:-1]], axis=0)
    prev_K = jnp.concatenate(
        [jnp.zeros((1, M), jnp.int32), K[:-1]], axis=0)

    jump = (filled != prev) & (prev >= 0)
    res = prev_K - prev_base                                   # valid at jumps

    i_from = jnp.where(jump, prev, S).ravel()
    i_to = jnp.where(jump, filled, S).ravel()
    one = jump.astype(jnp.int32).ravel()
    resv = jnp.where(jump, res, 0).ravel()

    n_ij = jnp.zeros((S + 1, S + 1), jnp.int32).at[i_from, i_to].add(one)
    lag = jnp.zeros((S + 1, S + 1), jnp.int32).at[i_from, i_to].add(resv)
    res_sum = jnp.zeros((S + 1,), jnp.int32).at[i_from].add(resv)
    res_cnt = jnp.zeros((S + 1,), jnp.int32).at[i_from].add(one)

    return dict(
        n_ij=n_ij[:S, :S],
        lag_sum=lag[:S, :S],
        res_sum=res_sum[:S],
        res_cnt=res_cnt[:S],
        occ_counts=occ[:S],
        last_sites=filled[-1],
        last_res=jnp.where(filled[-1] >= 0, K[-1] - run_base[-1], 0),
    )
