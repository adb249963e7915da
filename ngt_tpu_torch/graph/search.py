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

A step (``_step``) is a handful of batched tensor ops that update a fixed
set of state tensors in place (``_Loop``).  The loop ends at ``max_iters``
or when every query is done, and each done check waits for the device.
On a CUDA device it runs ``REPLAY_STEPS`` steps between two checks as one
captured CUDA graph, replayed with one host call; the graphs and their
state are cached on everything the steps read (``_graph_key``), so a
repeated shape captures once, and a lock per card lets one call at a time
use that card's cached states: calls on different cards run at once.  Off
CUDA, where a check costs nothing, it checks every ``EAGER_STEPS`` steps.
A step taken after every query is done changes no
state, and a device counter counts only the steps in which some query was
not done, so the answers, the counts and the steps equal a loop that
checks before every step.  The sq8 block traversal on a card
(``_kernel_route``) runs instead as one launch of the traversal kernel
(``ops/traverse.py``), in which each query takes its own steps to done:
queries never read each other's state, so that equals the lockstep loop,
whose steps are the most any query took.  The function counts its steps
(``graph_search.steps``); with the tracer's search family on
(``ngt_tpu_torch/trace.py``) it also counts each query's own steps, the
replays, the spare steps and the captures, and splits the loop's host time
at the done checks.  Row mode scores gathered object rows; block mode
scores one neighbor block row per expanded node, the quantized graph's
traversal (``quant/qgraph.py``).
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ngt_tpu_torch import trace
from ngt_tpu_torch.ops import distances as D
from ngt_tpu_torch.ops import traverse as TV
from ngt_tpu_torch.ops.select import sort_lex
from ngt_tpu_torch.properties import DistanceType
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
    * ``scorer(queries, rows) -> [B, E]`` replaces the metric distance; the
      captured graphs are keyed on its ``kind`` (``quant/pq.py``), and a
      scorer that names none runs eagerly;
    * ``x_sqnorm`` [N_pad]: the rows' squared norms, which the metric
      distance reads (Cosine, Angle, Poincare) instead of recomputing;
    * ``block_mode``: ``x`` holds one block row [E_max * M] per node, the
      codes of its neighbors in adjacency order, so one row read per
      expanded node scores all its neighbors (the reference's QuantizedNode
      stream, QuantizedGraph.h:64-115); seeds are then scored from the
      per-object rows ``seed_x``.

    With the tracer's search family on, one record per name ends the call:
    ``traverse.steps`` (its steps), ``traverse.launch`` (host seconds from
    the end of one done check to the start of the next: the replays' and
    steps' launches), ``traverse.wait`` (host seconds blocked in the
    checks), ``traverse.replays`` (graph replays, or runs of
    ``EAGER_STEPS`` eager steps off CUDA), ``traverse.spare_steps`` (steps
    run after every query was done) and ``traverse.captures`` (graphs
    captured); on the kernel route also ``traverse.kernel_launches``."""
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
    q_sq = D.sq_norms(queries) if scorer is None and x_sqnorm is not None else None

    def score(xs, ids, lo, hi):
        if scorer is not None:
            return scorer(queries[lo:hi], xs)
        rows_sq = None if x_sqnorm is None else x_sqnorm[ids]
        return D.gathered(metric, queries[lo:hi], xs, xs_sqnorm=rows_sq,
                          q_sqnorm=None if q_sq is None else q_sq[lo:hi])

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

    traced = trace.on(trace.SEARCH)
    ins = _Inputs(x, nbr[:, :e], valid, x_sqnorm, metric, scorer, block_mode, e_max)
    key = _graph_key(ins, queries, w=w, p=p, k=k, kr=kr, hash_bits=hash_bits,
                     exact_hash=exact_hash, epsilon=epsilon)
    args = (ins, queries, q_sq, pool_d, pool_i, radius, max_iters, k)

    def new_loop():
        return _Loop(queries, w, k, kr, p, hash_bits, exact_hash, epsilon, q_sq is not None)

    if key is None:
        res = _run(new_loop(), *args, False, traced)
    else:
        # a cached loop's state is shared by every call of its key: one call
        # on its card at a time holds it, from the seed pool's copy to the
        # outputs' read
        with _card_lock(key[0]), torch.cuda.device(dev):
            with _CACHE_LOCK:
                loop = _GRAPHS.get(key)
                if loop is not None:
                    _GRAPHS.move_to_end(key)
            if loop is None:
                loop = _keep(key, new_loop())
            res = _run(loop, *args, True, traced)
    with _CACHE_LOCK:
        graph_search.steps += res.iters
    return res


#: loop steps summed over calls since it was last set to 0 (counted with the
#: tracer off too)
graph_search.steps = 0

#: traversal steps between two done checks on CUDA: one captured graph of
#: this many steps.  A chunk then runs at most REPLAY_STEPS - 1 spare steps
#: (0.4% of a 1,875-step chunk, 15% of a 23-step one), and a replay's host
#: call and check are small beside its steps' device time.
REPLAY_STEPS = 8
#: steps between two done checks off CUDA, where a check costs nothing
EAGER_STEPS = 1

#: captured graphs kept per card, the least recently used dropped first:
#: the qg route's five batch buckets (32-512 rows,
#: ``quant/qgraph.py::_bucket``) for three (epsilon, size) pairs, with a
#: slot to spare
GRAPH_CACHE = 16
#: bytes of state a card's kept graphs may hold together (the newest is
#: kept whatever its size): a 512-row chunk at 2^20 visited bits holds
#: 64 MiB, a 10,000-query exact-route batch 1.25 GiB
GRAPH_CACHE_BYTES = 4 << 30

#: key -> _Loop of each captured graph (CUDA only); a key's first entry
#: names its card
_GRAPHS: collections.OrderedDict = collections.OrderedDict()
#: held to look up, add or drop entries of ``_GRAPHS`` and to count steps
_CACHE_LOCK = threading.Lock()
#: card -> the lock a call holds while it uses one of that card's cached
#: loops, captures included
_CARD_LOCKS: dict = {}
#: CUDA device index -> the stream graphs are captured on
_CAPTURE_STREAMS: dict = {}


def _card_lock(card) -> threading.Lock:
    with _CACHE_LOCK:
        return _CARD_LOCKS.setdefault(card, threading.Lock())


def _card(key):
    return key[0] if isinstance(key, tuple) else None


def _keep(key, loop: _Loop) -> _Loop:
    """Caches ``loop`` under ``key``, dropping the least recently used
    loops of its card past ``GRAPH_CACHE`` entries or
    ``GRAPH_CACHE_BYTES`` there; other cards' loops stay."""
    card = _card(key)
    with _CACHE_LOCK:
        _GRAPHS[key] = loop
        while True:
            mine = [k for k in _GRAPHS if _card(k) == card]
            if not (len(mine) > GRAPH_CACHE or (
                    len(mine) > 1
                    and sum(_GRAPHS[k].nbytes for k in mine) > GRAPH_CACHE_BYTES)):
                return loop
            del _GRAPHS[mine[0]]


class _Inputs(NamedTuple):
    """What a step reads besides its state: the call's graph tensors
    (``nbr`` already cut to the edges read) and how rows are scored."""
    x: torch.Tensor
    nbr: torch.Tensor
    valid: torch.Tensor
    x_sqnorm: torch.Tensor | None
    metric: object
    scorer: object
    block_mode: bool
    e_max: int


class _Loop:
    """The state tensors of one traversal, updated in place by ``_step``
    (the static buffers of a captured graph), the constants a step reads,
    and on CUDA the captured graph of ``REPLAY_STEPS`` steps."""

    def __init__(self, queries, w, k, kr, p, hash_bits, exact_hash, epsilon, has_q_sq):
        b, dev = queries.shape[0], queries.device
        self.b, self.w, self.kr, self.p = b, w, kr, p
        self.hash_bits, self.exact_hash = hash_bits, exact_hash
        self.eps_coeff = torch.tensor(1.0, dtype=_F32) + torch.tensor(epsilon, dtype=_F32)
        self.queries = torch.empty_like(queries, memory_format=torch.contiguous_format)
        self.q_sq = torch.empty((b,), dtype=_F32, device=dev) if has_q_sq else None
        self.radius0 = torch.empty((b,), dtype=_F32, device=dev)
        self.pool_d = torch.empty((b, w), dtype=_F32, device=dev)
        self.pool_i = torch.empty((b, w), dtype=torch.int32, device=dev)
        self.pool_e = torch.empty((b, w), dtype=torch.bool, device=dev)
        self.visited = torch.empty((b, (1 << hash_bits) // 32), dtype=torch.int32, device=dev)
        self.done = torch.empty((b,), dtype=torch.bool, device=dev)
        self.vc = torch.empty((b,), dtype=torch.int32, device=dev)
        self.dc = torch.empty((b,), dtype=torch.int32, device=dev)
        #: each query's steps begun while it was not done
        self.own = torch.empty((b,), dtype=torch.int32, device=dev)
        #: steps in which some query was not done when the step started
        self.steps = torch.empty((), dtype=torch.int64, device=dev)
        self.bits = torch.from_numpy(_BITS).to(dev)
        self.rows = torch.arange(b, device=dev)
        self.rank_ge_k = (torch.arange(w, device=dev) >= k)[None, :]
        self.pos = torch.arange(w, device=dev)
        self.inf = torch.tensor(INF, dtype=_F32, device=dev)
        self.no_id = torch.tensor(-1, dtype=torch.int32, device=dev)
        self.graph = None
        self.nbytes = sum(t.numel() * t.element_size() for t in (
            self.queries, self.pool_d, self.pool_i, self.pool_e, self.visited))

    def start(self, queries, q_sq, pool_d, pool_i, radius) -> None:
        """Writes a call's queries and seed pool into the state."""
        self.queries.copy_(queries)
        if q_sq is not None:
            self.q_sq.copy_(q_sq)
        self.radius0.fill_(radius)
        self.pool_d.copy_(pool_d)
        self.pool_i.copy_(pool_i)
        self.pool_e.zero_()
        self.visited.zero_()
        self.done.copy_(~(pool_i >= 0).any(1))
        self.vc.zero_()
        self.dc.zero_()
        self.own.zero_()
        self.steps.zero_()


def _graph_key(ins: _Inputs, queries, **consts):
    """Everything the captured steps read, or None where the loop runs
    eagerly: off CUDA, and for a scorer that names no ``kind``.  A tensor
    is keyed by its address, shape, strides and type: a graph replayed on
    a tensor equal in all four reads that tensor's current contents, so
    in-place updates (``DeviceMirror.update_rows``) keep the key, and a
    new tensor (``sync_full``) makes another.  The queries and the radius
    are copied into the loop's buffers by each call, so only the queries'
    shape and type are keyed."""
    if queries.device.type != "cuda":
        return None
    if ins.scorer is not None and not hasattr(ins.scorer, "kind"):
        return None

    def sig(t):
        return None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)

    return (
        str(queries.device), tuple(queries.shape), queries.dtype,
        sig(ins.x), sig(ins.nbr), sig(ins.valid), sig(ins.x_sqnorm),
        ins.metric, getattr(ins.scorer, "kind", None), ins.block_mode, ins.e_max,
        tuple(sorted(consts.items())),
    )


def _kernel_route(ins: _Inputs, queries, t: _Loop) -> bool:
    """Whether ``_run`` launches the traversal kernel (``ops/traverse.py``),
    decided from the inputs alone: the sq8 block traversal on a CUDA card
    (block mode, L2 with no scorer, one expansion a step, int8 or uint8
    block rows, float32 queries) at sizes within the kernel's limits (edges
    read, query width, visited bits, one query's shared memory).  Every
    other call steps ``_step``."""
    return (
        queries.device.type == "cuda" and ins.block_mode and ins.scorer is None
        and DistanceType(ins.metric) == DistanceType.L2 and t.p == 1
        and ins.x.dtype in (torch.int8, torch.uint8) and queries.dtype == torch.float32
        and TV.takes(t.w, ins.nbr.shape[1], queries.shape[1], t.hash_bits)
    )


def _run(t: _Loop, ins: _Inputs, queries, q_sq, pool_d, pool_i, radius, max_iters: int,
         k: int, graphed: bool, traced: bool) -> SearchResult:
    """Writes a call's queries and seed pool into ``t`` and steps it until
    every query is done or ``max_iters`` steps ran: one launch of the
    traversal kernel on the kernel route (``_kernel_route``); else
    ``REPLAY_STEPS`` steps between two done checks when ``graphed`` (a
    replay of the captured graph, captured on the first run of
    ``REPLAY_STEPS`` steps after one eager step), else ``EAGER_STEPS``;
    single eager steps for the steps left below that.  The outputs are made
    before the steps are read back, so that read also waits for them, and
    ``t`` is free for the next call once this returns."""
    t.start(queries, q_sq, pool_d[:, :t.w], pool_i[:, :t.w], radius)
    if _kernel_route(ins, queries, t):
        return _run_kernel(t, ins, max_iters, k, traced)
    m = REPLAY_STEPS if graphed else EAGER_STEPS
    replays = eager = captures = 0
    launch_ns = wait_ns = 0
    t_start = t_back = time.perf_counter_ns() if traced else 0
    left = max_iters
    while left > 0:
        if traced:
            t_check = time.perf_counter_ns()
            all_done = bool(t.done.all())
            launch_ns += t_check - t_back
            t_back = time.perf_counter_ns()
            wait_ns += t_back - t_check
        else:
            all_done = bool(t.done.all())
        if all_done:
            break
        if left < m or (graphed and t.graph is None):
            # the first step of a new graph runs eagerly: the ops then make
            # what they create on first use before the capture
            _step(t, ins)
            eager += 1
            left -= 1
            if graphed and left >= m:
                t.graph = _capture(t, ins)
                captures += 1
            continue
        if graphed:
            t.graph.replay()
        else:
            for _ in range(m):
                _step(t, ins)
        replays += 1
        left -= m
    t_end = time.perf_counter_ns() if traced else 0
    res = _result(t, k, traced)
    if traced:
        it = res.iters
        wait_ns += time.perf_counter_ns() - t_end
        trace.add("traverse.steps", it)
        trace.add("traverse.launch", (launch_ns + t_end - t_back) / 1e9, t_start)
        trace.add("traverse.wait", wait_ns / 1e9, t_start)
        trace.add("traverse.replays", replays)
        trace.add("traverse.spare_steps", replays * m + eager - it)
        trace.add("traverse.captures", captures)
    return res


def _run_kernel(t: _Loop, ins: _Inputs, max_iters: int, k: int, traced: bool) -> SearchResult:
    """The kernel route of ``_run``: one launch steps every query of ``t``
    to done or ``max_iters``, then one read back.  It replays, captures and
    spares nothing; ``traverse.launch`` is the host's time to issue the
    launch, ``traverse.wait`` the read back's."""
    t_start = time.perf_counter_ns() if traced else 0
    TV.traverse(
        ins.x, ins.nbr, ins.valid, t.queries, t.radius0, t.pool_d, t.pool_i, t.pool_e,
        t.visited, t.done, t.vc, t.dc, t.own, t.steps, e_max=ins.e_max, k=k, kr=t.kr,
        eps_coeff=float(t.eps_coeff), hash_bits=t.hash_bits, exact_hash=t.exact_hash,
        max_iters=max_iters,
    )
    t_end = time.perf_counter_ns() if traced else 0
    res = _result(t, k, traced)
    if traced:
        trace.add("traverse.steps", res.iters)
        trace.add("traverse.launch", (t_end - t_start) / 1e9, t_start)
        trace.add("traverse.wait", (time.perf_counter_ns() - t_end) / 1e9, t_start)
        trace.add("traverse.replays", 0)
        trace.add("traverse.spare_steps", 0)
        trace.add("traverse.captures", 0)
        trace.add("traverse.kernel_launches", 1)
    return res


def _result(t: _Loop, k: int, traced: bool) -> SearchResult:
    """The call's outputs from ``t``'s state; reading the step count waits
    for the device."""
    out_d, out_i = t.pool_d[:, :k], t.pool_i[:, :k]
    keep = out_d <= t.radius0[:, None]
    return SearchResult(
        torch.where(keep, out_i, -1), torch.where(keep, out_d, INF),
        t.vc.clone(), t.dc.clone(), int(t.steps), t.own.clone() if traced else None,
    )


def _capture(t: _Loop, ins: _Inputs):
    """``REPLAY_STEPS`` steps of ``t`` captured as one CUDA graph on the
    current device (nothing runs until it is replayed).  Only this
    thread's calls are held to the capture's rules, so other threads may
    use the card meanwhile."""
    dev = torch.cuda.current_device()
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream, capture_error_mode="thread_local"):
        for _ in range(REPLAY_STEPS):
            _step(t, ins)
    return g


def _step(t: _Loop, ins: _Inputs) -> None:
    """One traversal step of every query, in place on ``t``'s state.  It
    neither synchronizes nor reads anything back, so a CUDA graph can hold
    it.  A query done when the step starts changes nothing: it selects no
    candidate, so its pool, visited words and counts stay as they are."""
    b, w, p = t.b, t.w, t.p
    nbr, done, pool_e = ins.nbr, t.done, t.pool_e
    n_pad, e = nbr.shape
    t.steps += ~done.all()
    t.own += ~done
    # explorationRadius (Graph.cpp:525): ε-scaled kr-th pool distance
    er = torch.minimum(t.pool_d[:, t.kr - 1], t.radius0) * t.eps_coeff

    cand = ~pool_e & (t.pool_i >= 0) & (t.pool_d <= er[:, None])
    done |= ~cand.any(1)
    # the p best unexpanded candidates in pool order (p = 1 is the
    # reference's one pop per step); past the candidates, the lowest
    # other positions, unselected
    if p == 1:
        cur = cand.to(torch.uint8).argmax(1, keepdim=True)
    else:
        key = torch.where(cand, t.pos, w + t.pos)
        cur = torch.topk(key, p, dim=1, largest=False, sorted=True).indices
    sel_ok = cand.gather(1, cur) & ~done[:, None]               # [B, p]
    cur_id = t.pool_i.gather(1, cur).to(torch.int64).clamp(0, n_pad - 1)

    # pop from the unchecked set + mark visited, one slot at a time (two
    # slots of a row may share a visited word)
    word, bit1, bit2 = _hash_slots(cur_id, t.hash_bits, t.exact_hash)
    mask = torch.where(sel_ok, t.bits[bit1] | t.bits[bit2], 0)
    for j in range(p):
        pool_e[t.rows, cur[:, j]] |= sel_ok[:, j]
        t.visited[t.rows, word[:, j]] |= mask[:, j]

    nb = nbr[cur_id].reshape(b, p * e)                          # [B, p*e]
    live_nb = (nb >= 0) & sel_ok[:, :, None].expand(b, p, e).reshape(b, p * e)
    nb_safe = nb.to(torch.int64).clamp(0, n_pad - 1)
    ok = live_nb & ins.valid[nb_safe]
    # visited test (distanceChecked, Graph.cpp:597): both bits set
    wn, nb1, nb2 = _hash_slots(nb_safe, t.hash_bits, t.exact_hash)
    wv = t.visited.gather(1, wn)
    seen = ((wv & t.bits[nb1]) != 0) & ((wv & t.bits[nb2]) != 0)
    ok &= ~seen
    # pool membership keeps the pool duplicate-free
    ok &= ~(nb[:, :, None] == t.pool_i[:, None, :]).any(2)
    if p > 1:
        # neighbors of two expanded nodes may coincide: first one wins
        ok &= ~_repeats(torch.where(ok, nb, -1), skip_negative=True)

    t.vc += live_nb.sum(1, dtype=torch.int32)
    t.dc += ok.sum(1, dtype=torch.int32)

    if ins.block_mode:
        # one block row per expanded node scores all its neighbors
        xs = ins.x[cur_id].view(b, p, ins.e_max, -1)[:, :, :e].reshape(b, p * e, -1)
    else:
        xs = ins.x[nb_safe]
    nd = _score(t, ins, xs, nb_safe)
    # admission: dist <= explorationRadius (Graph.cpp:605-607)
    nd = torch.where(ok & (nd <= er[:, None]), nd, INF)
    ni = torch.where(torch.isinf(nd), -1, nb)

    md, mi, me = sort_lex(
        torch.cat([t.pool_d, nd], 1), torch.cat([t.pool_i, ni], 1),
        torch.cat([pool_e, torch.zeros_like(ok)], 1),
    )
    # expanded entries ranked past k are neither results nor frontier
    evict = me[:, :w] & t.rank_ge_k
    torch.where(evict, t.inf, md[:, :w], out=t.pool_d)
    torch.where(evict, t.no_id, mi[:, :w], out=t.pool_i)
    torch.logical_and(me[:, :w], ~evict, out=pool_e)


def _score(t: _Loop, ins: _Inputs, xs, ids):
    """The step's distances from each query to its rows ``xs`` [B, E, ...]
    (object rows of ``ids``, or block rows)."""
    if ins.scorer is not None:
        return ins.scorer(t.queries, xs)
    rows_sq = None if ins.x_sqnorm is None else ins.x_sqnorm[ids]
    return D.gathered(ins.metric, t.queries, xs, xs_sqnorm=rows_sq, q_sqnorm=t.q_sq)


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
