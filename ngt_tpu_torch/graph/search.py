"""Batched best-first graph traversal (the port's counterpart of
``ngt_tpu/graph/search.py``) — the redesign of ``NeighborhoodGraph::search``
(reference lib/NGT/Graph.cpp:499-638) for a vector machine:

* B queries traverse together;
* the reference's unchecked heap + result heap become ONE pool of width W
  per query, kept sorted on (dist, id); its first k entries are the result
  heap and ``radius`` is the k-th pool distance (Graph.cpp:609-616);
* each step expands the best unexpanded pool entry within ε·radius — the
  pop rule ``top.distance > ε·radius ⇒ stop`` (Graph.cpp:541-543) becomes
  a per-query done flag;
* the visited set (``distanceChecked``) is a per-query bit table indexed by
  id while the id space fits it (exact), else by a multiplicative hash
  (two bits in one word; collisions only skip candidates).

The loop is a Python loop over steps; each step is a handful of batched
tensor ops and the loop ends at ``max_iters`` or when every query is done,
which it checks once per step (the check waits for the device).  The
function counts its steps (``graph_search.steps``); with the tracer's
search family on (``ngt_tpu_torch/trace.py``) it also counts each query's
own steps and splits the steps' host time at the done check.  Row mode
scores gathered object rows; block mode scores one neighbor block row per
expanded node, the quantized graph's traversal (``quant/qgraph.py``).
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ngt_tpu_torch import trace
from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops.select import sort_lex
from ngt_tpu_torch.seeds import top_seeds

_F32 = torch.float32
INF = float("inf")

#: default exploration coefficient 1 + ε with ε = 0.1
#: (reference NGT_EXPLORATION_COEFFICIENT, defines.h.in:52)
DEFAULT_EPSILON = 0.1

#: elements of the seed rows gathered for one chunk of queries: the sharded
#: index seeds every query with all of a shard's representatives (n/32 at
#: 1M rows), whose [B, S, D] gather would not fit at once
SEED_GATHER_ELEMS = 1 << 27

#: 1 << j for j in 0..31 as int32 bit patterns (bit 31 is the sign bit)
_BITS = np.array([1 << j for j in range(32)], dtype=np.uint32).view(np.int32)


def wrap_hash_bits(capacity: int, override: int = 0) -> tuple[int, bool]:
    """Visited-table sizing: exact (identity-indexed) up to 2^20 ids, else
    hashed into 2^20 bits (128 KiB per query)."""
    if override > 0:
        bits = override
    else:
        bits = max(min(int(math.ceil(math.log2(max(capacity, 2)))), 20), 10)
    return bits, capacity <= (1 << bits)


class SearchResult(NamedTuple):
    ids: torch.Tensor          # [B, k] int32, -1 where empty
    dists: torch.Tensor        # [B, k] f32, +inf where empty
    visit_count: torch.Tensor  # [B] int32 — neighbors looked at
    dist_count: torch.Tensor   # [B] int32 — distance computations
    iters: int                 # loop steps executed
    #: [B] int32 with the tracer's search family on, else None: the steps
    #: in which each query was not yet done when the step started (the
    #: ``iters`` it takes when searched alone)
    own_steps: torch.Tensor | None = None


def _hash_slots(ids: torch.Tensor, hash_bits: int, exact: bool):
    """ids (non-negative) -> (word, bit1, bit2) of a [2^hash_bits]-bit
    table.  Exact: identity, bit2 == bit1.  Lossy: a double-hash Bloom test
    with both bits in one 32-bit word.  The reference's uint32 multiply
    wraparound (ngt_tpu/graph/search.py:96-105) is reproduced in int64
    masked to 32 bits: ids < 2^31 times a 32-bit constant stay below 2^63."""
    u = ids.to(torch.int64)
    if exact:
        return u >> 5, u & 31, u & 31
    m32 = 0xFFFFFFFF
    h1 = ((u * 2654435761) & m32) >> (32 - hash_bits)
    bit1 = h1 & 31
    h2 = ((u * 2246822519) & m32) >> 27
    bit2 = (bit1 + 1 + h2 % 31) & 31
    return h1 >> 5, bit1, bit2


def graph_search(
    x: torch.Tensor,         # [N_pad, D_pad] object rows, or block rows
    nbr: torch.Tensor,       # [N_pad, E_max] int32 adjacency, -1 padded
    valid: torch.Tensor,     # [N_pad] bool — searchable objects
    queries: torch.Tensor,   # [B, D_pad] prepared queries
    seed_ids: torch.Tensor,  # [B, S] int32, -1 padded
    *,
    metric,
    k: int,
    k_radius: int = 0,
    epsilon: float = DEFAULT_EPSILON,
    radius: float = INF,
    width: int = 64,
    edge_size: int = 0,
    max_iters: int = 0,
    hash_bits: int = 16,
    exact_hash: bool = False,
    expand: int = 1,
    scorer=None,
    block_mode: bool = False,
    seed_x: torch.Tensor | None = None,
    x_sqnorm: torch.Tensor | None = None,
) -> SearchResult:
    """One batched k-NN search over a fixed proximity graph.

    * ``edge_size`` (0 = all) limits the edges read per expansion
      (Graph.h:675-692);
    * ``k_radius`` (0 = k) is the pool rank that drives the radius rule:
      below k the search explores with the tighter radius and the other
      candidates ride along in the pool (the quantized graph's result
      expansion);
    * ``expand`` > 1 expands that many candidates per step: fewer steps,
      more distance computations;
    * ``scorer(queries, rows) -> [B, E]`` replaces the metric distance;
    * ``x_sqnorm`` [N_pad]: the rows' squared norms, which the metric
      distance reads (Cosine, Angle, Poincare) instead of recomputing;
    * ``block_mode``: ``x`` holds one block row [E_max * M] per node, the
      codes of its neighbors in adjacency order, so one row read per
      expanded node scores all its neighbors (the reference's QuantizedNode
      stream, QuantizedGraph.h:64-115); seeds are then scored from the
      per-object rows ``seed_x``.

    With the tracer's search family on, one record per name ends the call:
    ``traverse.steps`` (its steps), ``traverse.launch`` (host seconds from
    the end of one done check to the start of the next: the step's
    launches) and ``traverse.wait`` (host seconds blocked in the checks)."""
    n_pad, e_max = nbr.shape
    b = queries.shape[0]
    dev = queries.device
    e = edge_size if 0 < edge_size < e_max else e_max
    w = max(width, k)
    s = seed_ids.shape[1]
    p = max(int(expand), 1)
    if max_iters <= 0:
        base = max(512, 4 * w + 32 * k)
        scale = max(float(n_pad) / 65536.0, 1.0)
        max_iters = int(base * (1.0 + math.log2(scale) / 2.0))
    kr = k_radius if 0 < k_radius <= k else k
    eps_coeff = torch.tensor(1.0, dtype=_F32) + torch.tensor(epsilon, dtype=_F32)
    radius0 = torch.full((b,), radius, dtype=_F32, device=dev)
    bits = torch.from_numpy(_BITS).to(dev)
    rows = torch.arange(b, device=dev)
    if scorer is None:
        q_sq = D.sq_norms(queries) if x_sqnorm is not None else None

        def score(xs, ids, lo=0, hi=b):
            rows_sq = None if x_sqnorm is None else x_sqnorm[ids]
            return D.gathered(metric, queries[lo:hi], xs, xs_sqnorm=rows_sq,
                              q_sqnorm=None if q_sq is None else q_sq[lo:hi])
    else:
        def score(xs, ids, lo=0, hi=b):
            return scorer(queries[lo:hi], xs)

    # ---- seed scoring (reference setupSeeds, Graph.cpp:243-394), in query
    # chunks of at most SEED_GATHER_ELEMS gathered elements
    seed64 = seed_ids.to(torch.int64)
    seed_safe = seed64.clamp(0, n_pad - 1)
    seed_rows = seed_x if block_mode else x
    step = max(1, SEED_GATHER_ELEMS // max(s * seed_rows.shape[1], 1))
    seed_d = torch.cat([
        score(seed_rows[seed_safe[lo : lo + step]], seed_safe[lo : lo + step], lo, lo + step)
        for lo in range(0, max(b, 1), step)
    ])
    seed_d = torch.where((seed64 >= 0) & valid[seed_safe], seed_d, INF)
    # a repeated seed id keeps its first occurrence only
    seed_d = torch.where(_repeats(seed64), INF, seed_d)
    seed_i = torch.where(torch.isinf(seed_d), -1, seed_ids.to(torch.int32))

    # ---- initial pool: seeds sorted on (dist, id), padded/cut to width W
    pad = max(w - s, 0)
    pool_d = torch.cat([seed_d, seed_d.new_full((b, pad), INF)], 1)
    pool_i = torch.cat([seed_i, seed_i.new_full((b, pad), -1)], 1)
    pool_d, pool_i = sort_lex(pool_d, pool_i)
    pool_d, pool_i = pool_d[:, :w].contiguous(), pool_i[:, :w].contiguous()
    pool_e = torch.zeros((b, w), dtype=torch.bool, device=dev)

    visited = torch.zeros((b, (1 << hash_bits) // 32), dtype=torch.int32, device=dev)
    done = ~(pool_i >= 0).any(1)
    vc = torch.zeros((b,), dtype=torch.int32, device=dev)
    dc = torch.zeros((b,), dtype=torch.int32, device=dev)
    pos = torch.arange(w, device=dev)
    rank_ge_k = (pos >= k)[None, :]
    nbr_e = nbr[:, :e]

    traced = trace.on(trace.SEARCH)
    own = torch.zeros((b,), dtype=torch.int32, device=dev) if traced else None
    launch_ns = wait_ns = 0
    t_start = t_back = time.perf_counter_ns() if traced else 0

    it = 0
    while it < max_iters:
        if traced:
            t_check = time.perf_counter_ns()
            all_done = bool(done.all())
            launch_ns += t_check - t_back
            t_back = time.perf_counter_ns()
            wait_ns += t_back - t_check
        else:
            all_done = bool(done.all())
        if all_done:
            break
        if traced:
            own += ~done
        # explorationRadius (Graph.cpp:525): ε-scaled kr-th pool distance
        er = torch.minimum(pool_d[:, kr - 1], radius0) * eps_coeff

        cand = ~pool_e & (pool_i >= 0) & (pool_d <= er[:, None])
        done = done | ~cand.any(1)
        # the p best unexpanded candidates in pool order (p = 1 is the
        # reference's one pop per step); past the candidates, the lowest
        # other positions, unselected
        if p == 1:
            cur = cand.to(torch.uint8).argmax(1, keepdim=True)
        else:
            key = torch.where(cand, pos, w + pos)
            cur = torch.topk(key, p, dim=1, largest=False, sorted=True).indices
        sel_ok = cand.gather(1, cur) & ~done[:, None]               # [B, p]
        cur_id = pool_i.gather(1, cur).to(torch.int64).clamp(0, n_pad - 1)

        # pop from the unchecked set + mark visited, one slot at a time (two
        # slots of a row may share a visited word)
        word, bit1, bit2 = _hash_slots(cur_id, hash_bits, exact_hash)
        mask = torch.where(sel_ok, bits[bit1] | bits[bit2], 0)
        for j in range(p):
            pool_e[rows, cur[:, j]] |= sel_ok[:, j]
            visited[rows, word[:, j]] |= mask[:, j]

        nb = nbr_e[cur_id].reshape(b, p * e)                        # [B, p*e]
        live_nb = (nb >= 0) & sel_ok.repeat_interleave(e, dim=1)
        nb_safe = nb.to(torch.int64).clamp(0, n_pad - 1)
        ok = live_nb & valid[nb_safe]
        # visited test (distanceChecked, Graph.cpp:597): both bits set
        wn, nb1, nb2 = _hash_slots(nb_safe, hash_bits, exact_hash)
        wv = visited.gather(1, wn)
        seen = ((wv & bits[nb1]) != 0) & ((wv & bits[nb2]) != 0)
        ok &= ~seen
        # pool membership keeps the pool duplicate-free
        ok &= ~(nb[:, :, None] == pool_i[:, None, :]).any(2)
        if p > 1:
            # neighbors of two expanded nodes may coincide: first one wins
            ok &= ~_repeats(torch.where(ok, nb, -1), skip_negative=True)

        vc += live_nb.sum(1, dtype=torch.int32)
        dc += ok.sum(1, dtype=torch.int32)

        if block_mode:
            # one block row per expanded node scores all its neighbors
            xs = x[cur_id].view(b, p, e_max, -1)[:, :, :e].reshape(b, p * e, -1)
        else:
            xs = x[nb_safe]
        nd = score(xs, nb_safe)
        # admission: dist <= explorationRadius (Graph.cpp:605-607)
        nd = torch.where(ok & (nd <= er[:, None]), nd, INF)
        ni = torch.where(torch.isinf(nd), -1, nb)

        md, mi, me = sort_lex(
            torch.cat([pool_d, nd], 1), torch.cat([pool_i, ni], 1),
            torch.cat([pool_e, torch.zeros_like(ok)], 1),
        )
        pool_d, pool_i, pool_e = md[:, :w], mi[:, :w], me[:, :w]
        # expanded entries ranked past k are neither results nor frontier
        evict = pool_e & rank_ge_k
        pool_d = torch.where(evict, INF, pool_d)
        pool_i = torch.where(evict, -1, pool_i)
        pool_e = pool_e & ~evict
        it += 1
    graph_search.steps += it
    if traced:
        trace.add("traverse.steps", it)
        trace.add("traverse.launch", (launch_ns + time.perf_counter_ns() - t_back) / 1e9, t_start)
        trace.add("traverse.wait", wait_ns / 1e9, t_start)

    out_d = pool_d[:, :k]
    out_i = pool_i[:, :k]
    keep = out_d <= radius0[:, None]
    return SearchResult(
        torch.where(keep, out_i, -1), torch.where(keep, out_d, INF), vc, dc, it, own
    )


#: loop steps summed over calls since it was last set to 0 (counted with the
#: tracer off too)
graph_search.steps = 0


def _repeats(ids: torch.Tensor, skip_negative: bool = False) -> torch.Tensor:
    """Flags every repeat of an id within its row after the first
    occurrence in position order (a stable sort, flags scattered back);
    with ``skip_negative`` negative ids are never flagged."""
    srt, order = torch.sort(ids, dim=1, stable=True)
    rep = srt[:, 1:] == srt[:, :-1]
    if skip_negative:
        rep &= srt[:, 1:] >= 0
    rep = torch.cat([torch.zeros_like(rep[:, :1]), rep], 1)
    return torch.zeros_like(rep).scatter(1, order, rep)


def seeded_search(
    x, nbr, valid, rep_rows, rep_ids, queries, *, metric, k, s, epsilon=DEFAULT_EPSILON,
    radius=INF, edge_size=0, width=64, max_iters=0, hash_bits=16, exact_hash=False,
    expand=1, x_sqnorm=None, rep_sq=None,
) -> SearchResult:
    """Seed scoring over the representative rows + graph search: the
    reference's tree descent + graph search (Index.h:1524-1567).
    ``x_sqnorm`` and ``rep_sq`` are the rows' and the reps' squared norms
    (ngt_tpu/graph/search.py:382-392)."""
    si = top_seeds(D.seed_scores(metric, queries, rep_rows, rep_sq=rep_sq), s)
    seeds = rep_ids[si]
    return graph_search(
        x, nbr, valid, queries, seeds,
        metric=metric, k=k, epsilon=epsilon, radius=radius, width=width,
        edge_size=edge_size, max_iters=max_iters, hash_bits=hash_bits,
        exact_hash=exact_hash, expand=expand, x_sqnorm=x_sqnorm,
    )
