#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ngt_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path at 1M x 128 float32 — ``create`` with default
properties -> ``batch_insert(build=True)`` (the bulk build, whose candidate
scan runs the hand-written window-scan kernel) -> ``batch_search``, which
takes the quantized-graph (qg) route at this size — then the exact-graph
route on the same index, then appends to and removals from the same live
index, then the routes past the sq8 block budget on the same rows (pq4
codes, the IVFPQ mirror), and checks each result:

 1. device: the card's name and power limit;
 2. build of the CUDA kernels from ``ngt_tpu_torch/csrc`` (plain nvcc): its
    ptxas registers, spills (any spill fails the run) and warnings, and the
    scan's shared-memory plan; then the host library (g++), so that no
    later phase times its first-use compile;
 3. the window-scan kernel against its plain torch version at 65,536 x 128
    with 1,024 queries, a ragged case (100 queries, 37 windows) and a
    masked case (scores to rtol 1e-4 / atol 1e-3, ids on >= 99.9% of
    entries: the tolerances of tests/test_pallas_scan.py), then at each of
    the kernel's wider plans (SCAN_WIDTHS, d = 256, 384, 512: seeded normal
    rows made on the card) at 65,536 rows x 1,024 queries and ragged;
 4. the kernel's time at the main path's shape (4096 queries x the 2^20-row
    store), beside its bound, the plain version and a library yardstick,
    and the same comparison at that shape; then the same at d = 256, 384
    and 512 (4096 x 2^20 x d: the kernels line's ``*_by_d`` entries);
    then the traversal kernel (``csrc/traverse.cu``) against the captured
    ``_step`` loop (``_kernel_route`` turned off) on the same blocks,
    seeds and state at the qg route's chunk shapes (TRAVERSE_SHAPES: a
    512-row SIFT chunk of int8 codes, a glove chunk reading 24 of 48 edges
    with the two-bit hashed table, a 2,048-row BIGANN shard chunk at 2^22
    exact bits, and the u8-exact route's uint8 blocks) on a 65,536-row
    clustered graph made on the card: ids on >= 99.9% of entries,
    distances to rtol 1e-5 where they agree, equal steps, equal visit,
    distance and own-step counts on the rows whose ids agree; the host's
    shared-memory count equal to the kernel's; each shape's traversal
    time on both routes beside the bound of its live query-steps (their
    bytes at 3.35 TB/s, or two dependent device-memory round trips a
    step, whichever is larger: the kernels line's ``traverse`` entry);
 5. the 1M build, with the kernel's launch count on that path and its phase
    split (the build's NGT_TPU_BUILD_PROFILE marks, each closed by a
    synchronize), and the kernel's share of the scan phase;
 6. build quality: the first edge_size_for_creation edges of 2,000 sampled
    rows against exact ground truth (>= 99% agreement) and ``verify``;
 7. the qg route of default properties over the first N_QG_Q held-out
    queries: the first call at epsilon 0.1 with NGT_TPU_QG_PROFILE=1,
    split by stage (quantize, block gather, seeds, traversal with its
    steps and its share of done-check waits, re-rank, tail refine); the
    route is sq8 with 48-edge blocks; recall@10 of a second call above
    QG_RECALL_FLOOR, and queries/s; the same call in one chunk: identical
    ids, and its queries/s; 1,000 self-queries; save and open through
    ``QuantizedGraphIndex``: identical ids;
 8. the exact route on the same index (``search_mode="exact"``): at least
    SELF_HIT_FLOOR of the 1,000 corpus rows find themselves first;
    recall@10 of the held-out queries above RECALL_FLOOR, and queries/s;
 9. save + open_index: the self-queries return identical ids;
10. the u8-exact arm: the proxy scaled and rounded to integers in 0..255,
    built and searched with default properties: the codes are the u8
    mirror tensor itself at scale 1.0, recall@10 of the first N_U8_Q
    held-out queries above QG_RECALL_FLOOR;
11. card against CPU: the qg route at 8,192 rows on the card and on the
    CPU over one graph, in the exact and the lossy visited regime: codes
    equal, ids on >= 99.9% of entries;
12. the Cosine arm at 1M, bench.py's angular protocol: ``glove_proxy``
    (1,000,000 x 100, seed 3, rows stored un-normalized), ``create`` with
    distance_type "Cosine" and edge_size_for_creation 40; the build scans
    a row-normalized copy through the window-scan kernel (its launches on
    this arm, its phase split); the first 40 edges of 2,000 rows against
    exact cosine k-NN (>= 99%) and ``verify``; 8,192 corpus rows as
    queries (``default_rng(23)``, size 11, the self-match stripped) on
    the qg route at epsilon 0.02: sq8 codes of the normalized rows,
    normalized traversal queries, eb and refine, recall@10 above
    COSINE_QG_RECALL_FLOOR against the card's exact linear search, its
    queries/s and stage split; the exact route at the same epsilon
    (printed only);
13. card against CPU for every metric and object type: each of the
    twelve metrics and an L2 index of BFLOAT16 objects built at 4,096
    rows on the card and on the CPU, searched with 256 queries: adjacency
    and exact-route ids on >= 99.9% of entries; for the metrics the qg
    route serves, its ids on >= 99.9% of entries, the sq8 scale to 1e-6
    relative and the codes equal on >= 99.99% of entries, never more than
    1 apart;
14. the live index, run right after phase 9 on phase 5's index (capacity
    2^20, so nothing grows it): a bulk append of 40,000 rows of the same
    clusters from a second stream (``batch_insert(build=True)``, default
    properties: the bulk append route, whose scan runs the window-scan
    kernel 10 times; its NGT_TPU_BUILD_PROFILE phases; one connected
    component after it); ``batch_remove`` of 10,000 ids of base and
    appended rows alike, then 16 single ``remove`` calls (seconds, rows
    changed); an incremental append of 2,048 rows (``build_anng``: two
    batches of 1,024 into freed slots; seconds and graph_search steps per
    batch); then ``verify() == []``, ``check_graph``, the qg route of
    default properties in one chunk of the 10,000 held-out queries with
    the stage timer on (the codes and blocks must rebuild): recall@10
    above QG_RECALL_FLOOR against the card's exact linear search over the
    live rows, no removed id in any result, at least SELF_HIT_FLOOR of
    1,000 bulk-appended and of 1,000 incrementally appended rows find
    themselves first; save + open_index: identical exact-route ids;
15. card against CPU for the mutation paths at 8,192 rows (the phase 11
    generator): bulk build, a ``build_anng`` append of 2,048 rows,
    ``batch_remove`` of 512, a bulk append of 4,096, each on the card and
    on the CPU port: adjacency and exact-route ids on >= 99.9% of entries
    after each step;
16. the pq4 route, run inside phase 5's run right after phase 14: phase
    9's save opened afresh under NGT_TPU_QG_BLOCK_GB=0.75 (set in-process,
    restored after), where 8 sq8 block columns no longer fit: the default
    route quantizes to pq4 (mode, subspaces, eb against the width rule at
    the opened capacity, refine), the 10,000 held-out queries at epsilon
    0.1 in one chunk with the stage timer on (quantize split into the
    codebook fit and the encode, block gather, seeds, traversal steps,
    re-rank, refine), recall@10 above PQ4_RECALL_FLOOR beside phase 7's
    sq8 recall, queries/s; save + open through ``QuantizedGraphIndex``:
    identical ids;
17. the IVFPQ crossover: the same save opened afresh under
    NGT_TPU_QG_MAX_GB=1, past the qg size ceiling: ``batch_search`` builds
    the auto IVFPQ mirror (488 centroids; its build split: coarse k-means,
    PQ fit, assign and encode, ``host_blocks``, upload), recall@10 of the
    held-out queries at nprobe 32, expansion 16, refine above
    IVFPQ_RECALL_FLOOR, queries/s; ``IVFPQIndex.verify() == []``; save +
    open: identical ids; ``batch_remove`` of 1,000 ids rebuilds the mirror
    and no removed id is served; then ``optimize_seeds`` (seconds) and the
    exact route's self-hits of phase 8's 1,000 rows beside phase 8's
    (printed only);
18. card against CPU for the quantization at 8,192 rows (the phase 11
    generator): the pq4 qg route with codebooks fitted on the card and
    carried to the CPU port (packed codes byte-equal, ids on >= 99.9% of
    entries), an ``IVFPQIndex`` built on the card and carried to the CPU in
    the approx, refine and exact modes and with the raw rows in an mmap
    file (ids on >= 99.9% of entries), and k-means from one host-drawn
    init on both (MSE within 1%).

19. the 1M angular ONNG, bench.py's protocol (bench.py:403-440), run
    inside phase 12 on its index before it closes: ``GraphOptimizer(
    out_edges=10, in_edges=120, tune_parameters=False).execute`` with
    NGT_TPU_BUILD_PROFILE=1 (materialize, reconstruct, detect, phase2,
    rows, mirror, seeds, each closed by a synchronize), the peak card memory, the
    phase-2 rule and window C, each ONNG program's seconds beside a bound
    from its bytes and operations; graph type ONNG, e_max 136, every degree
    <= 136, no row below min(10, its degree before the path adjustment),
    ``verify() == []``; then bench's five settings on the same 8,192
    queries (ef 0 at epsilon 0 and 0.02, ef 33, ef 48 with
    result_expansion 5, ef 64 with 6): recall@10 against phase 12's ground
    truth and queries/s each; the sq8 qg route with blocks of the ONNG's
    rows; recall@10 at epsilon 0.02 above COSINE_QG_RECALL_FLOOR; save +
    open_index: identical ids;
20. card against CPU for the reconstruction at N_ONNG_CHECK rows (the phase 11
    generator, edge_size_for_creation 40): ``GraphOptimizer(10, 120,
    tune_parameters=True)`` tuned on 64 extracted queries, on a card
    index fed from its build's deferred device rows and on a CPU copy,
    under the default rule (R(1) at this n*e) and under
    NGT_TPU_ADJUST_DEVICE_MIN=0 (R(8)); then
    ``reconstruct_graph_with_constraint`` and ``refine_anng`` (epsilon
    0.02, exact route): adjacency ids, degrees and distances equal after each ONNG
    step and equal accuracy tables (the CPU copy takes the card's k-means
    seeds), and exact- and qg-route ids of 400 queries on >= 99.9% of
    entries at the card's tuned edge size (``refine_anng`` searches, so its rows are
    held to the same share).

21. the CLI at 1M: phase 10's integer rows (1,000,000 x 128 values in
    0..255, in float) written as a TSV (seconds and bytes), then
    ``create -d 128 -D L2 <index> <tsv>`` through ``ngt_tpu_torch.cli.main``
    in-process (its TSV parse and build seconds, the window-scan launches
    of its bulk build); the result opened: ``verify() == []`` and the first
    10 edges of 2,000 sampled rows against exact k-NN (>= 99%); then
    ``python -m ngt_tpu_torch search -o e -n 10 -Q <N_CLI_Q> <index>
    <queries.tsv>`` as a subprocess on phase 10's held-out rows (the exact
    route, since the CLI asks for stats), its stream parsed with the CLI's
    ``_parse_eval_stream``: ids equal to in-process one-query
    ``batch_search(..., with_stats=True)`` calls, recall@10 against ground
    truth above CLI_RECALL_FLOOR, the mean query ms and the command's
    seconds;
22. export and import at 1M: ``python -m ngt_tpu_torch export`` of phase
    21's index to a binary stream and ``import`` into a new directory
    (seconds and bytes of each; the stream deleted after): objects,
    validity, free slots, adjacency, degrees, node set and seeds equal,
    and the imported index's ids on the same queries equal (default and
    exact routes); then ``open_index(memory_mapped=True)`` of phase 21's
    directory: exact-route ids equal to the plain open's, and after a
    removal, an insert into the freed slot and its ``build_index`` every
    file's sha256 unchanged;
23. ``batch_insert_dedup`` on the live 1M index (phase 21's, opened on the
    card): 10,000 rows, 5,000 of them base rows moved by 2.0 (+-1 on four
    coordinates, radius DEDUP_RADIUS) and 5,000 held-out rows farther than
    the radius from every stored and every other new row: the copies come
    back identical with their source ids at distance 2.0, the new rows are
    inserted through the bulk append (its window-scan launches), the index
    verifies; the card's ``sqrt`` is correctly rounded (the CPU's root goes
    through float64 to match it); then at 8,192 rows the card's
    ``(ids, identical, dist)`` equal the CPU port's;
24. sharding at full width, generated fresh after phase 23: sift_proxy
    (its own seed) at 2,000,000 + 10,000 rows, ``make_mesh(2)`` (two
    shards of 1,000,000 rows on the one card, one process):
    ``ShardedIndex.build`` with its defaults (edge_size_for_creation 10,
    max_edges 48), the window-scan launches of each shard's build;
    ``batch_search`` of the first N_SHARD_Q held-out queries at epsilon
    0.1, recall@10 against the card's exact search over the 2M rows (floor
    SHARDED_RECALL_FLOOR); ``ShardedQG.from_sharded_index`` (codes and
    blocks built on the card, peak card memory) and 1,000 queries
    (SHARDED_QG_RECALL_FLOOR); ``ShardedIVFPQ`` over a port ``IVFPQIndex``
    of the same rows (1,024 centroids, dsub 2, ksub 16; nprobe 32,
    expansion 16): ``memory_report``, shard loads within 2x of the mean,
    distances exact, recall (SHARDED_IVFPQ_RECALL_FLOOR); then
    ``save_distributed`` -> ``open_distributed`` under a one-rank NCCL
    group (``multihost.initialize`` with a FileStore): ids of 2,000
    queries equal to the in-memory search; seconds by stage;
25. the sharded programs card against CPU at 8,192 rows, P = 2 (the phase
    11 generator): ``ShardedIndex.build`` rows equal, adjacency and
    ``batch_search`` ids >= 99.9%; ``ShardedQG`` from one set of host
    arrays: scale, codes and blocks byte-equal, ids >= 99.9%;
    ``ShardedIVFPQ`` of one CPU-built ``IVFPQIndex`` (carried to the card
    by convert.py): ids >= 99.9%; 4 ``make_sharded_build_step`` steps of
    256 rows into free slots (laid out by ``shard_host_index`` with spare
    ``valid=False`` rows, over one exact per-shard KNNG): new neighbor ids,
    ``nbr``, ``nbr_dist`` (1e-5) >= 99.9% and ``valid`` equal;
26. the C ABI on the card: ``native.build_capi()``, then a C program this
    file owns (SMOKE_C, compiled with g++ against the library and
    libpython) run with the default device (cuda): every entry point of
    NGT's C API at the sizes of the JAX package's C test, then
    ``ngt_open_index`` of phase 21's 1M index and N_CAPI_Q
    ``ngt_search_index_as_float`` calls, whose ids must equal in-process
    ``Index.search`` on the same opened index;
27. each ``samples/torch`` script's ``main`` in-process on the card at
    SAMPLE_ARGS' sizes (their own checks: self-matches, the radius bound,
    recall@10 above 0.9, ``verify``), with their seconds;
28. bench.py's 4M arm (bench.py:768-877), after phase 27's data is freed:
    bench's synthetic 5,000 x 128 base tiled 800 times plus
    ``default_rng(4)`` noise of scale 12, rounded, clipped to 0..255 and
    stored as uint8, 4,096 noisy base rows as queries; the card memory
    reckoned beforehand; ``create(dimension=128,
    edge_size_for_creation=40)`` and the bulk build with its phase split:
    exactly ceil(4,000,000 / 4,096) = 977 window-scan launches at the
    2^22-row capacity, edge agreement of 2,000 rows >= 0.99; ground truth
    by ``batch_linear_search``; then under NGT_TPU_QG_BLOCK_GB=8 bench's
    certified row (epsilon 0, ef 72, result_expansion 8) over all 4,096
    queries: the sq8 route, eb 16 (8.6e9 bytes of blocks, past 2^31
    elements), refine, the stage split, queries/s, peak card memory,
    recall@10 above RECALL_FLOOR_4M; bench's HBM diet is skipped;
29. bench.py's gist-960 arm (bench.py:480-560): ``gist_proxy(500_000,
    960)``, 4,096 corpus rows as queries (``default_rng(29)``, self
    stripped); ``create(dimension=960, edge_size_for_creation=40)`` and the
    bulk build, whose d_pad of 1,024 is past the kernel's 512: the scan
    takes the blocked route and launches the kernel 0 times; edge agreement
    >= 0.99; under NGT_TPU_QG_BLOCK_GB=8.5 two of bench's rows (epsilon
    0.02; epsilon 0 with ef 96 and result_expansion 10): mode, eb, refine,
    recall@10, queries/s, the better recall above GIST_RECALL_FLOOR;
30. the port's entry points (``ngt_tpu_torch/graft_entry.py``):
    ``entry()`` on the card against ``entry(device="cpu")`` (ids on
    >= 99.9% of entries, distances to 1e-4), then ``dryrun_multichip(8)``,
    its 8 shards on the one card.

To stay under 1,000 s the smoke runs four earlier paths at a smaller
depth: the u8 arm's qg recall over N_U8_Q held-out queries, phase 20 at
N_ONNG_CHECK rows, phase 7's three qg calls over N_QG_Q queries and phase
24's ``batch_search`` over N_SHARD_Q.

Phases 16-20 launch no hand kernel (pq4, k-means, IVFPQ and the ONNG
programs are torch code; the ONNG is rebuilt from the ANNG that phase 12's
build made through the window-scan kernel), so the kernels line lists the
window-scan kernel's launches by path only; phases 21 and 23 launch it
through the CLI's bulk build and the dedup's bulk append, phase 24 through
each shard's build, phase 28 through the 4M build.  The traversal kernel
runs every sq8 qg search on the card; the kernels line counts its launches
on the main path's qg calls (phase 7), the u8 arm, the Cosine arm's qg
call and the sharded quantized graph's search.  It prints a few dozen
short lines as it goes, then one JSON line of the
kernels, the nvidia-smi line and, last, one JSON line with ``"ok": true``.
Any failure raises, so the run exits non-zero and prints no result; so
does a machine without a CUDA device.  Data is generated from a seed.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_BASE = 1_000_000
N_HELD_OUT = 10_000
DIM = 128
SEED = 11
#: recall@10 floor of the 10,000 held-out queries at epsilon 0.1: the first
#: H100 run measured 0.9873 on this data; the floor sits 1.7 points below to
#: absorb reduction-order changes across torch/CUDA versions (PERF.md)
RECALL_FLOOR = 0.97
#: share of 1,000 corpus rows that must return themselves first.  Not 1.0:
#: seeds are a 1/32 sample of the rows, so a small cluster may hold no seed,
#: and the exact k-NN graph rarely leads into it from another cluster.  The
#: JAX package misses the same rows on the same data (PERF.md).
SELF_HIT_FLOOR = 0.99
#: recall@10 floor of the same queries on the quantized-graph route that
#: default properties take (the sq8 and the u8-exact arm): the first H100
#: run measured 0.9874 (sq8) and 0.9883 (u8); the floor sits 1.24 points
#: below the lower (PERF.md)
QG_RECALL_FLOOR = 0.975
#: the Cosine arm (phase 12): bench.py's 1M angular protocol
N_GLOVE, N_GLOVE_Q, GLOVE_DIM = 1_000_000, 8192, 100
#: recall@10 floor of the Cosine arm's qg route at epsilon 0.02 (the JAX
#: package's notes claim 0.9818 for this protocol on its own hardware)
COSINE_QG_RECALL_FLOOR = 0.97
#: rows and queries of each index of phase 13
N_METRIC, N_METRIC_Q, METRIC_DIM = 4096, 256, 64
#: phase 14, the live index: rows of the bulk append (of sift_proxy's
#: clusters, a second stream), ids of the batch removal and of the single
#: removals, rows of the incremental append (two batches of 1,024)
N_APPEND, N_REMOVE, N_SINGLE, N_INCR = 40_000, 10_000, 16, 2048
#: phase 16: the block budget under which phase 9's 1M index no longer fits
#: 8 sq8 block columns (0.75 GiB / (1,000,001 x 128 B) = 6), so the default
#: route quantizes to pq4
PQ4_BLOCK_GB = 0.75
#: phase 17: the size ceiling under which even the 8-column sq8 blocks and
#: codes of that index (1.07 GiB) do not fit, so batch_search builds the
#: auto IVFPQ mirror
IVFPQ_MAX_GB = 1.0
#: recall@10 floors of phases 16 (pq4) and 17 (the IVFPQ mirror at nprobe
#: 32, expansion 16): the first H100 run's values (0.6080 and 0.9874,
#: NVIDIA H100 80GB HBM3 at 700 W; PERF.md) less 1.5 points.  pq4's 4-bit
#: codes over 2-dim subspaces blur the neighbourhoods of this clustered
#: corpus, in the reference as in the port (tests/pq4_recall_vs_jax.py)
PQ4_RECALL_FLOOR = 0.593
IVFPQ_RECALL_FLOOR = 0.9724
#: phase 19: bench.py's angular ONNG call (bench.py:403-440) and its five
#: search settings (ef, result_expansion, epsilon); 0 leaves the property
ONNG_OUT, ONNG_IN = 10, 120
ONNG_SETTINGS = ((0, 0.0, 0.0), (0, 0.0, 0.02), (33, 0.0, 0.0), (48, 5.0, 0.0),
                 (64, 6.0, 0.0))
#: phase 21: held-out queries of the CLI's search subprocess (each one is a
#: separate exact-route call, in the subprocess and again in-process, about
#: 0.4 s each on the card; 100 brought the whole smoke to 900 s)
N_CLI_Q = 50
#: recall@10 floor of those queries against exact ground truth: the lowest
#: of the measured runs (0.9870 over 100 queries, 0.9960 over these 50; H100
#: 80GB HBM3 at 700 W; PERF.md) less 1.7 points, as RECALL_FLOOR
CLI_RECALL_FLOOR = 0.97
#: phase 23: rows of the dedup batch (copies of base rows, new rows), the
#: radius, and the rows of its card-against-CPU check
N_DEDUP_COPY, N_DEDUP_NEW, DEDUP_RADIUS, N_DEDUP_SMALL = 5000, 5000, 8.0, 8192
#: depth cuts that keep the whole smoke under 1,000 s beside phases 24-27:
#: the u8 arm's qg recall runs over the first N_U8_Q of the 10,000 held-out
#: queries and phase 20 compares the card with the CPU at N_ONNG_CHECK rows
#: (not the 8,192 of the other card-against-CPU phases)
N_U8_Q, N_ONNG_CHECK = 2000, 4096
#: phase 24: rows of the two 1M-row shards (sift_proxy, a seed of its own),
#: queries of the sharded qg search and of the reopened index, the sharded
#: IVFPQ's centroids, nprobe and expansion
N_SHARD, SHARD_SEED, N_SHARD_QG_Q, N_SHARD_REOPEN_Q = 2_000_000, SEED + 2, 1000, 2000
SHARD_IVF_CENTROIDS, SHARD_IVF_NPROBE, SHARD_IVF_EXP = 1024, 32, 16.0
#: recall@10 floors of phase 24 (batch_search at epsilon 0.1, ShardedQG at
#: epsilon 0.1, ShardedIVFPQ): the first H100 runs' 0.9914, 0.9919 and
#: 0.9937-0.9941 (NVIDIA H100 80GB HBM3 at 700 W; PERF.md) less 1.5 points
#: of the highest
SHARDED_RECALL_FLOOR, SHARDED_QG_RECALL_FLOOR, SHARDED_IVFPQ_RECALL_FLOOR = 0.9764, 0.9769, 0.9791
#: phase 25: rows the four build steps insert into free slots
N_STEP_ROWS = 1024
#: phase 26: queries of the C program's searches of phase 21's index
N_CAPI_Q = 50
#: phase 27: each sample's arguments on the card (empty: its defaults);
#: large_single_chip and ngtq_10m run cut from 4M and 10M rows
SAMPLE_ARGS = {
    "l2_float": [], "cosine_float": [], "hamming_uint8": [], "hyperbolic": [],
    "jaccard_sparse": [], "quantized_graph": [], "range_search": [], "sharded_search": [],
    "large_single_chip": ["--n", "100000", "--queries", "1024"],
    "ngtq_10m": ["--n", "1000000", "--queries", "1024", "--centroids", "1024"],
}
#: phases 3-4 at the kernel's wider shared-memory plans (row widths past 128)
SCAN_WIDTHS = (256, 384, 512)
#: depth cuts that make room for phases 28-30 under 1,000 s: phase 7's qg
#: calls (the first, the second and the one-chunk call) run over the first
#: N_QG_Q held-out queries, phase 24's batch_search over the first N_SHARD_Q
N_QG_Q, N_SHARD_Q = 2048, 2000
#: the traversal kernel's shapes in phase 4, the qg route's chunks at the
#: cells' widths: dimension d (padded to 128), block width eb of 64
#: adjacency columns, e edges read, pool width w, k, kr, epsilon, the
#: visited table (bits, exact or the two-bit hash), queries b, uint8 codes
TRAVERSE_ROWS = 65536
TRAVERSE_SHAPES = {
    "sift": dict(d=128, eb=48, e=48, w=64, k=30, kr=10, eps=0.1, bits=20, exact=True,
                 b=512, u8=False),
    "glove": dict(d=100, eb=48, e=24, w=64, k=30, kr=10, eps=0.02, bits=20, exact=False,
                  b=512, u8=False),
    "bigann": dict(d=128, eb=48, e=48, w=64, k=30, kr=10, eps=0.1, bits=22, exact=True,
                   b=2048, u8=False),
    "u8_exact": dict(d=128, eb=48, e=48, w=64, k=30, kr=10, eps=0.1, bits=20, exact=True,
                     b=512, u8=True),
}
#: device memory bandwidth and one dependent round trip to it (H100 SXM),
#: the traversal kernel's two bounds
HBM_BYTES_PER_S, HBM_ROUND_TRIP_S = 3.35e12, 0.6e-6
#: the traversal kernel's launches by path (phases 7, 10, 12 and 24)
TRAVERSE_LAUNCHES: dict = {}
#: phase 28: bench.py's 4M arm (bench.py:768-877): bench's 5,000-row
#: synthetic base tiled TILE_4M times plus normal noise (bench.py:786-790),
#: N_4M_Q noisy base rows as queries (bench.py:792-795), its block budget
#: (bench.py:826-830) and its certified (epsilon, ef, result_expansion) row
N_BASE5K, TILE_4M, NOISE_4M, N_4M_Q = 5000, 800, 12.0, 4096
N_4M = N_BASE5K * TILE_4M
BLOCK_GB_4M = "8"
ROW_4M = (0.0, 72, 8.0)
#: recall@10 floor of that row: the first H100 run's 0.9851 (NVIDIA H100
#: 80GB HBM3 at 700 W; PERF.md) less 1.5 points
RECALL_FLOOR_4M = 0.9701
#: phase 29: bench.py's gist-960 arm (bench.py:480-560): gist_proxy rows,
#: N_GIST_Q corpus rows as queries (self stripped), its block budget
#: (bench.py:535-538) and two of its (epsilon, ef, result_expansion) rows
#: (0: the property stays)
N_GIST, N_GIST_Q, GIST_DIM = 500_000, 4096, 960
BLOCK_GB_GIST = "8.5"
ROWS_GIST = ((0.02, 0, 0.0), (0.0, 96, 10.0))
#: recall@10 floor of the better row: the first H100 run's 0.9512 (epsilon 0,
#: ef 96; NVIDIA H100 80GB HBM3 at 700 W; PERF.md) less 1.5 points
GIST_RECALL_FLOOR = 0.9362
#: H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core FLOP/s, HBM
#: bytes/s, and the float32 rate outside the tensor cores, the yardstick of
#: the compares, sorts and index arithmetic of the ONNG programs (K10)
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_CUDA_CORE = 67e12


_T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - _T0:7.1f} s] {msg}", flush=True)


def sift_proxy(n: int, d: int = DIM, seed: int = SEED, kc: int = 2048,
               extra: int = 0, extra_seed: int = 0):
    """A SIFT-shaped clustered corpus: a power-law spectrum (i^-0.4) under a
    random rotation, Zipf(1.05) cluster sizes, shifted non-negative, rows
    shuffled (the recipe of bench.py's gist_proxy, at d = 128).  With
    ``extra`` > 0 it also returns that many further rows of the same
    clusters and shift, drawn from a second stream (``extra_seed``), so
    the first n rows do not change."""
    rng = np.random.default_rng(seed)
    v = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    s = np.arange(1, d + 1, dtype=np.float32) ** -0.4
    w = np.arange(1, kc + 1, dtype=np.float64) ** -1.05
    sizes = rng.multinomial(n, w / w.sum())
    centers = (rng.normal(size=(kc, d)).astype(np.float32) * (0.9 * s)) @ v.T
    out = np.empty((n, d), np.float32)
    off = 0
    for c in range(kc):
        m = sizes[c]
        if m:
            noise = rng.normal(size=(m, d)).astype(np.float32) * (0.45 * s)
            out[off : off + m] = centers[c] + noise @ v.T
            off += m
    shift = np.abs(out.min(axis=0, keepdims=True))
    out += shift
    out = out[rng.permutation(n)]
    if not extra:
        return out
    r2 = np.random.default_rng(extra_seed)
    pick = r2.choice(kc, extra, p=w / w.sum())
    more = centers[pick] + (r2.normal(size=(extra, d)).astype(np.float32) * (0.45 * s)) @ v.T
    return out, (more + shift).astype(np.float32)


def glove_proxy(n: int, d: int = GLOVE_DIM, seed: int = 3, kc: int = 4096) -> np.ndarray:
    """A glove-100-shaped angular corpus (bench.py's generator): a
    power-law spectrum (i^-0.1) under a random rotation, Zipf(1.05) cluster
    sizes, per-cluster log-normal anisotropy and log-normal row norms
    (stored un-normalized)."""
    rng = np.random.default_rng(seed)
    v = np.linalg.qr(rng.normal(size=(d, d)))[0].astype(np.float32)
    s = np.arange(1, d + 1, dtype=np.float32) ** -0.1
    w = np.arange(1, kc + 1, dtype=np.float64) ** -1.05
    w /= w.sum()
    sizes = rng.multinomial(n, w)
    centers = (rng.normal(size=(kc, d)).astype(np.float32) * (0.8 * s)) @ v.T
    out = np.empty((n, d), np.float32)
    off = 0
    for c in range(kc):
        m = sizes[c]
        if m == 0:
            continue
        local = s * rng.lognormal(0.0, 0.15, size=d).astype(np.float32)
        local *= rng.uniform(0.9, 1.2)
        out[off : off + m] = centers[c] + (rng.normal(size=(m, d)).astype(np.float32) * local) @ v.T
        off += m
    out *= rng.lognormal(0.0, 0.35, size=(n, 1)).astype(np.float32)
    return out[rng.permutation(n)]


def strip_self(ids11: np.ndarray, self_ids: np.ndarray) -> np.ndarray:
    """The first 10 ids of each row other than the query's own id."""
    keep = ids11 != self_ids[:, None]
    order = np.argsort(~keep, axis=1, kind="stable")[:, :10]
    return np.where(np.take_along_axis(keep, order, 1),
                    np.take_along_axis(ids11, order, 1), -1)


def time_ms(fn, warm: int = 3, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings after `warm` warm-up runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def clocks_under(fn, launches: int = 1200) -> str:
    """SM clock and board power sampled by nvidia-smi every 100 ms while
    `fn` runs `launches` times back to back."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    rows = [ln.split(",") for ln in out.strip().splitlines()]
    rows = [r for r in rows
            if len(r) == 2 and all(re.fullmatch(r"\s*[0-9.]+\s*", v) for v in r)]
    if not rows:
        return "no nvidia-smi samples"
    clk = [float(c) for c, _ in rows]
    pw = [float(w) for _, w in rows]
    return (f"SM clock median {np.median(clk):.0f} MHz (min {min(clk):.0f}), board power "
            f"median {np.median(pw):.1f} W (max {max(pw):.1f}) over {len(rows)} samples")


def compare_scan(WS, q16, x16, ss, what: str) -> float:
    """Kernel vs plain on the same inputs; returns the max abs score error
    over unmasked entries, raises on disagreement."""
    wd, wi = WS.window_scan(q16, x16, ss)
    pd, pi = WS.window_scan_plain(q16, x16, ss)
    torch.cuda.synchronize()
    ids = (wi == pi).double().mean().item()
    close = bool(torch.isclose(wd, pd, rtol=1e-4, atol=1e-3).all())
    live = pd < float(WS.BIG) * 0.5
    err = float((wd - pd).abs()[live].max()) if bool(live.any()) else 0.0
    log(f"scan vs plain [{what}]: ids agree {ids:.6f}, scores within "
        f"rtol 1e-4/atol 1e-3: {close}, max abs err {err:.3g}")
    if ids < 0.999 or not close:
        raise AssertionError(f"window scan disagrees with its plain version ({what})")
    return err


def library_scan(q16, x16, ss, chunk: int = 65536):
    """Yardstick: torch.matmul of the bf16 tile, then the window min of the
    f32 scores (blocked over the corpus).  The port never calls it."""
    b = q16.shape[0]
    outs = []
    for s in range(0, x16.shape[0], chunk):
        sc = ss[None, s : s + chunk] - 2.0 * torch.matmul(q16, x16[s : s + chunk].T).float()
        outs.append(sc.view(b, -1, 128).min(-1))
    return outs


def qg_split(wall_s: float, n_chunks: int) -> None:
    """Print where the time of one qg call made with NGT_TPU_QG_PROFILE=1
    went: seconds per stage (quant/qgraph.py ``last_profile``) and the
    traversal's steps and done-check waits (graph/search.py's count and
    the tracer's ``traverse.wait`` records)."""
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.quant import qgraph as QG

    for label in ("quantize", "blocks", "seeds", "traverse", "rerank", "refine"):
        sec = QG.last_profile.get(label)
        log(f"  {label}: " + ("not run" if sec is None else
                              f"{sec * 1e3:.1f} ms ({100 * sec / wall_s:.1f}% of the call)"))
    trav = QG.last_profile.get("traverse", 0.0)
    wait = sum(r.value for r in trace.records() if r.name == "traverse.wait")
    log(f"  traversal: {graph_search.steps} steps over {n_chunks} chunks "
        f"({1e3 * trav / max(graph_search.steps, 1):.3f} ms a step); the done checks "
        f"wait {wait * 1e3:.1f} ms of its {trav * 1e3:.1f} ms "
        f"({100 * wait / max(trav, 1e-9):.1f}%)")


def traverse_launches(path: str, dev) -> None:
    """Record the traversal kernel's launches since its count was set to 0
    under ``path`` in TRAVERSE_LAUNCHES; raises if a search on the card
    never launched it."""
    from ngt_tpu_torch.ops import traverse as TV

    n = TV.traverse.launches
    TRAVERSE_LAUNCHES[path] = n
    log(f"traverse launches on {path}: {n}")
    if dev.type == "cuda" and n == 0:
        raise AssertionError(f"{path} never launched the traversal kernel")


def self_queries(search, base, sel, what: str) -> np.ndarray:
    ids, _ = search(base[sel])
    hits = int((ids[:, 0] == sel).sum())
    log(f"{what} self-queries: {hits} of {len(sel)} return themselves first")
    return ids


def recall_run(search, held, gt, what: str, kind: str):
    """One timed batch of the held-out queries; returns recall@10 and the
    ids found."""
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.ops import bruteforce as BF

    graph_search.steps = 0
    t0 = time.time()
    found, _ = search(held)
    secs = time.time() - t0
    rec = BF.recall_at_k(found, gt, 10)
    log(f"{what}: recall@10 {rec:.4f} at epsilon 0.1, {len(held) / secs:.0f} queries/s "
        f"({len(held)} in {secs:.2f} s, {graph_search.steps} steps) on {kind}")
    return rec, found


def ground_truth(idx, held: np.ndarray) -> np.ndarray:
    return np.concatenate([
        idx.batch_linear_search(held[i : i + 2000], size=10)[0]
        for i in range(0, len(held), 2000)
    ])


def check_qg_route(idx, codes_dtype) -> None:
    """The index served its last search through the quantized graph, sq8
    codes of ``codes_dtype`` with 48-edge blocks (the 6 GiB budget at a
    2^20-row capacity)."""
    qg = idx._qg
    if qg is None or qg.mode != "sq8":
        raise AssertionError("the default-properties search did not take the sq8 qg route")
    eb = qg._dev_blocks()[1].shape[1]
    log(f"qg route: mode {qg.mode}, codes {str(qg._dev_codes().dtype)}, scale "
        f"{qg.sq_scale!r}, eb {eb} of {idx.graph.e_max}, refine "
        f"{qg._resolve_refine(idx.graph.e_max, eb)}")
    if eb != 48 or qg._dev_codes().dtype != codes_dtype:
        raise AssertionError(f"qg route took eb {eb}, codes {qg._dev_codes().dtype}")


def drive(base: np.ndarray, held: np.ndarray, extra: np.ndarray, dev, kind: str,
          scan_ms: float) -> tuple[int, int, float]:
    """Phases 5-9 and 14 on `dev`: the main path (create with default
    properties, bulk build, search on the qg route, then the exact route on
    the same index, save and open), then the live index (appends and
    removals on the same index) and their checks.  Returns the window-scan
    launches of the build and of the bulk append, and phase 14's seconds."""
    import ngt_tpu_torch
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.ops import traverse as TV
    from ngt_tpu_torch.ops import window_scan as WS
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.quant import qgraph as QG
    from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

    n_base, n_held = len(base), len(held)
    tmp = tempfile.mkdtemp(prefix="ngt_tpu_torch_smoke_")
    try:
        path = os.path.join(tmp, "index")
        # 5. the main path: build ...
        os.environ["NGT_TPU_BUILD_PROFILE"] = "1"
        WS.window_scan.launches = 0
        t0 = time.time()
        idx = ngt_tpu_torch.create(path, dimension=base.shape[1], device=dev)
        idx.batch_insert(base, build=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build_launches = WS.window_scan.launches
        del os.environ["NGT_TPU_BUILD_PROFILE"]
        log(f"build of {n_base} x {base.shape[1]}: {time.time() - t0:.1f} s on "
            f"{kind}; window_scan launches {build_launches}")
        if dev.type == "cuda" and build_launches == 0:
            raise AssertionError("the build never launched the window-scan kernel")
        phases = dict(TB.last_profile)
        log("build phases (s): " + ", ".join(
            f"{label} {sec:.3f}" for label, sec in TB.last_profile))
        log(f"window_scan share of the scan phase: {build_launches} x {scan_ms:.3f} ms "
            f"= {build_launches * scan_ms / 1e3:.3f} s of {phases['scan']:.3f} s "
            f"({100 * build_launches * scan_ms / 1e3 / phases['scan']:.1f}%)")

        # 6. build quality: the first k edges against exact k-NN.  Reading
        # the host graph brings the adjacency the build left on the card down
        rows_down = idx.graph._deferred[3] if idx.graph._deferred else 0
        t0 = time.time()
        idx.graph._materialize()
        log(f"deferred adjacency download ({rows_down} rows of {idx.graph.e_max} ids + "
            f"distances): {time.time() - t0:.2f} s")
        edge_agreement(idx, base, "build quality", min(2000, n_base))
        problems = idx.verify()
        if problems:
            raise AssertionError(f"verify: {problems}")
        gt = ground_truth(idx, held)
        sel = np.random.default_rng(1).choice(n_base, min(1000, n_base), replace=False)

        # 7. default properties: the quantized-graph route, over the first
        # N_QG_Q held-out queries (a depth cut).  The first call quantizes
        # and gathers the blocks; it runs with the stage timer on
        nq = min(N_QG_Q, n_held)
        os.environ["NGT_TPU_QG_PROFILE"] = "1"
        QG.last_profile.clear()
        graph_search.steps = 0
        trace.clear()
        TV.traverse.launches = 0
        t0 = time.time()
        idx.batch_search(held[:nq], size=10, epsilon=0.1)
        first_s = time.time() - t0
        del os.environ["NGT_TPU_QG_PROFILE"]
        log(f"qg route, first call of {nq} queries (quantize + blocks + search, "
            f"a synchronize closing each stage): {first_s:.2f} s; where the time went:")
        qg_split(first_s, -(-nq // 512))
        log(f"device memory after the first qg call: {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB allocated (mirror, adjacency, codes, blocks and the store's linear-search "
            f"copy), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check_qg_route(idx, torch.int8)
        rec, found = recall_run(lambda q: idx.batch_search(q, size=10, epsilon=0.1),
                                held[:nq], gt[:nq], "qg route", kind)
        if rec < QG_RECALL_FLOOR:
            raise AssertionError(f"qg recall@10 {rec:.4f} below {QG_RECALL_FLOOR}")
        sq8_rec = rec
        # the same call in one chunk: the ids must not change, and the time
        # shows what the 512-query chunks cost
        os.environ["NGT_TPU_QG_CHUNK"] = str(nq)
        graph_search.steps = 0
        t0 = time.time()
        whole = idx.batch_search(held[:nq], size=10, epsilon=0.1)[0]
        secs = time.time() - t0
        del os.environ["NGT_TPU_QG_CHUNK"]
        log(f"qg route in one chunk of {nq}: {nq / secs:.0f} queries/s "
            f"({secs:.2f} s, {graph_search.steps} steps); ids identical to the "
            f"512-query chunks: {bool(np.array_equal(whole, found))}")
        if not np.array_equal(whole, found):
            raise AssertionError("qg results depend on the chunking")
        qg_self = self_queries(lambda q: idx.batch_search(q, size=10), base, sel, "qg route")
        qg = idx._qg
        t0 = time.time()
        qg.save()
        qg2 = QuantizedGraphIndex.open(path, device=dev)
        mine = qg.batch_search(base[sel], size=10, epsilon=0.1)[0]
        again = qg2.batch_search(base[sel], size=10, epsilon=0.1)[0]
        same = bool(np.array_equal(again, mine))
        log(f"qg save + open + search: {time.time() - t0:.1f} s; identical ids: {same}")
        if not same or not np.array_equal(mine, qg_self):
            raise AssertionError("qg results changed across QuantizedGraphIndex.save/open")
        qg2.index.close()
        del qg, qg2
        traverse_launches("main path: qg search (phase 7)", dev)

        # 8. the exact route on the same index
        idx.prop.search_mode = "exact"
        self_ids = self_queries(lambda q: idx.batch_search(q, size=10), base, sel,
                                "exact route")
        hits = int((self_ids[:, 0] == sel).sum())
        if hits < SELF_HIT_FLOOR * len(sel):
            raise AssertionError(f"only {hits} of {len(sel)} corpus rows found themselves")
        rec, _ = recall_run(lambda q: idx.batch_search(q, size=10, epsilon=0.1), held, gt,
                            "exact route", kind)
        if rec < RECALL_FLOOR:
            raise AssertionError(f"recall@10 {rec:.4f} below {RECALL_FLOOR}")
        launches = WS.window_scan.launches

        # 9. save and open
        t0 = time.time()
        idx.save()
        idx2 = ngt_tpu_torch.open_index(path, device=dev)
        again, _ = idx2.batch_search(base[sel], size=10)
        same = bool(np.array_equal(again, self_ids))
        log(f"save + open + search: {time.time() - t0:.1f} s; identical ids: {same}")
        if not same:
            raise AssertionError("results changed across save/open")
        idx2.close()
        del idx2
        torch.cuda.empty_cache()

        # 14. the live index: the same index takes appends and removals
        idx.prop.search_mode = "auto"
        append_launches, live_s = live_index(idx, base, held, extra, dev, kind, tmp)
        idx.close()
        del idx
        torch.cuda.empty_cache()

        # 16-17. phase 9's save on the routes past the sq8 budget
        pq4_route(path, base, held, gt, sel, sq8_rec, dev, kind, tmp)
        torch.cuda.empty_cache()
        ivfpq_crossover(path, base, held, gt, sel, hits, dev, kind, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, append_launches, live_s


def live_index(idx, base: np.ndarray, held: np.ndarray, extra: np.ndarray, dev, kind: str,
               tmp: str) -> tuple[int, float]:
    """Phase 14: phase 5's 1M index takes a bulk append of N_APPEND rows
    (through the window-scan kernel), a batch removal and single removals,
    and an incremental append of N_INCR rows into the freed slots, then
    serves the default route.  Returns the window-scan launches of the
    bulk append and the phase's seconds."""
    import ngt_tpu_torch
    from ngt_tpu_torch import native, trace
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import window_scan as WS
    from ngt_tpu_torch.quant import qgraph as QG

    t_phase = time.time()
    n0 = len(base)
    bulk_rows, incr_rows = extra[:N_APPEND], extra[N_APPEND : N_APPEND + N_INCR]

    # 1. bulk append through the window-scan kernel
    os.environ["NGT_TPU_BUILD_PROFILE"] = "1"
    WS.window_scan.launches = 0
    t0 = time.time()
    new_ids = idx.batch_insert(bulk_rows, build=True)
    torch.cuda.synchronize()
    launches = WS.window_scan.launches
    del os.environ["NGT_TPU_BUILD_PROFILE"]
    log(f"live index: bulk append of {N_APPEND} rows to {n0}: {time.time() - t0:.2f} s; "
        f"window_scan launches {launches} (predicted {-(-N_APPEND // 4096)})")
    log("live index: bulk append phases (s): " + ", ".join(
        f"{label} {sec:.3f}" for label, sec in TB.last_profile))
    if launches != -(-N_APPEND // 4096):
        raise AssertionError(f"the bulk append launched the kernel {launches} times")
    if not np.array_equal(new_ids, np.arange(n0, n0 + N_APPEND)):
        raise AssertionError("the bulk append did not take fresh slots")
    n = idx.store.repository_size
    t0 = time.time()
    _, comps = native.connected_components(idx.graph.nbr_ids[:n], idx.graph._has_node[:n])
    log(f"live index: {comps} connected component(s) after the bulk append "
        f"(host union-find over {n} rows: {time.time() - t0:.2f} s)")
    if comps != 1:
        raise AssertionError(f"{comps} components after the bulk append")

    # 2. removal: one batch, then single ids
    rng = np.random.default_rng(SEED + 7)
    gone = rng.choice(n0 + N_APPEND, N_REMOVE + N_SINGLE, replace=False)
    batch, singles = np.sort(gone[:N_REMOVE]), gone[N_REMOVE:]
    before = idx.graph.nbr_ids[:n].copy()
    t0 = time.time()
    idx.batch_remove(batch)
    torch.cuda.synchronize()
    secs = time.time() - t0
    after = idx.graph.nbr_ids[:n]
    log(f"live index: batch_remove of {len(batch)} ids ({int((batch >= n0).sum())} of them "
        f"appended rows): {secs:.2f} s, {int((before != after).any(1).sum())} adjacency "
        "rows changed")
    before = after.copy()
    times = []
    for e in singles:
        t0 = time.time()
        idx.remove(int(e))
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    log(f"live index: {len(singles)} single removes: {sum(times):.2f} s (median "
        f"{np.median(times) * 1e3:.0f} ms, max {max(times) * 1e3:.0f} ms), "
        f"{int((before != idx.graph.nbr_ids[:n]).any(1).sum())} adjacency rows changed")
    del before, after

    # 3. incremental append into the freed slots (build_anng)
    graph_search.steps = 0
    t0 = time.time()
    incr_ids = idx.batch_insert(incr_rows, build=True)
    torch.cuda.synchronize()
    secs = time.time() - t0
    reused = int(np.isin(incr_ids, gone).sum())
    log(f"live index: incremental append of {N_INCR} rows: {secs:.2f} s, {reused} of them "
        f"into freed slots; batches (rows, s, graph_search steps): "
        + ", ".join(f"({b}, {t:.2f}, {st})" for b, t, st in TB.last_batches))
    if len(TB.last_batches) != -(-N_INCR // idx.prop.device_batch_size) or reused != N_INCR:
        raise AssertionError("the incremental append did not run build_anng into freed slots")
    still_gone = np.setdiff1d(gone, incr_ids)

    # 4. search the mutated index
    problems = idx.verify()
    if problems:
        raise AssertionError(f"verify after the mutations: {problems}")
    t0 = time.time()
    cg = idx.check_graph()
    log(f"live index: verify() == []; check_graph {cg} ({time.time() - t0:.1f} s)")
    gt = ground_truth(idx, held)
    if np.isin(gt, still_gone).any():
        raise AssertionError("exact linear search returned a removed id")
    os.environ["NGT_TPU_QG_PROFILE"] = "1"
    os.environ["NGT_TPU_QG_CHUNK"] = str(len(held))
    QG.last_profile.clear()
    graph_search.steps = 0
    trace.clear()
    t0 = time.time()
    found, _ = idx.batch_search(held, size=10, epsilon=0.1)
    secs = time.time() - t0
    del os.environ["NGT_TPU_QG_PROFILE"]
    check_qg_route(idx, torch.int8)
    rec = BF.recall_at_k(found, gt, 10)
    once = sum(QG.last_profile.get(st, 0.0) for st in ("quantize", "blocks"))
    log(f"live index: qg route recall@10 {rec:.4f} at epsilon 0.1 over the live rows, "
        f"{len(held) / secs:.0f} queries/s in one chunk of {len(held)} ({secs:.2f} s, "
        f"{graph_search.steps} steps; {len(held) / max(secs - once, 1e-9):.0f} queries/s "
        f"without the re-encode and block gather) on {kind}; where the time went:")
    qg_split(secs, 1)
    if "quantize" not in QG.last_profile or "blocks" not in QG.last_profile:
        raise AssertionError("the qg codes or blocks were not rebuilt after the mutations")
    if rec < QG_RECALL_FLOOR:
        raise AssertionError(f"live-index qg recall@10 {rec:.4f} below {QG_RECALL_FLOOR}")
    if np.isin(found, still_gone).any():
        raise AssertionError("the qg route returned a removed id")
    rows = np.random.default_rng(SEED + 8)
    pick_b = rows.choice(N_APPEND, 1000, replace=False)
    live_b = pick_b[~np.isin(new_ids[pick_b], gone)]
    for what, ids_, vecs in (("bulk-appended", new_ids[live_b], bulk_rows[live_b]),
                             ("incrementally appended", incr_ids[:1000], incr_rows[:1000])):
        got, _ = idx.batch_search(vecs, size=10)
        hits = float((got[:, 0] == ids_).mean())
        log(f"live index: {what} rows: {hits:.4f} of {len(ids_)} find themselves first "
            "(qg route)")
        if hits < SELF_HIT_FLOOR:
            raise AssertionError(f"{what} self-hits {hits:.4f} below {SELF_HIT_FLOOR}")
        if np.isin(got, still_gone).any():
            raise AssertionError("a self-query returned a removed id")
    del os.environ["NGT_TPU_QG_CHUNK"]
    path = os.path.join(tmp, "live")
    idx.prop.search_mode = "exact"
    t0 = time.time()
    idx.save(path)
    again = ngt_tpu_torch.open_index(path, device=dev)
    mine = idx.batch_search(held[:1000], size=10)[0]
    theirs = again.batch_search(held[:1000], size=10)[0]
    same = bool(np.array_equal(mine, theirs))
    log(f"live index: save + open_index + exact-route search: {time.time() - t0:.1f} s; "
        f"identical ids: {same}")
    if not same or np.isin(mine, still_gone).any():
        raise AssertionError("the mutated index changed across save/open")
    again.close()
    secs = time.time() - t_phase
    log(f"live index: phase total {secs:.1f} s")
    return launches, secs


def stage_env(**env):
    """Sets the environment variables given (None unsets one) and returns
    a function that restores the earlier values."""
    old = {k: os.environ.get(k) for k in env}

    def put(vals):
        for k, v in vals.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(env)
    return lambda: put(old)


def pq4_route(path: str, base: np.ndarray, held: np.ndarray, gt: np.ndarray, sel: np.ndarray,
              sq8_rec: float, dev, kind: str, tmp: str) -> None:
    """Phase 16: phase 9's saved 1M index opened afresh under
    NGT_TPU_QG_BLOCK_GB=0.75, where 8 sq8 block columns no longer fit: the
    default route quantizes to pq4 and serves the held-out queries in one
    chunk with the stage timer on; recall@10 against the exact ground
    truth above PQ4_RECALL_FLOOR; save + open through
    QuantizedGraphIndex: identical ids."""
    import ngt_tpu_torch
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.quant import qgraph as QG

    restore = stage_env(NGT_TPU_QG_BLOCK_GB=str(PQ4_BLOCK_GB), NGT_TPU_QG_PROFILE="1",
                        NGT_TPU_QG_CHUNK=str(len(held)))
    try:
        t0 = time.time()
        idx = ngt_tpu_torch.open_index(path, device=dev)
        idx.prop.search_mode = "auto"   # phase 9 saved phase 8's "exact"
        log(f"pq4 route: open_index of phase 9's save: {time.time() - t0:.1f} s")
        QG.last_profile.clear()
        graph_search.steps = 0
        trace.clear()
        t0 = time.time()
        found, _ = idx.batch_search(held, size=10, epsilon=0.1)
        secs = time.time() - t0
        qg = idx._qg
        if qg is None or qg.mode != "pq4":
            raise AssertionError("the default route did not take pq4 under the tight budget")
        cap = idx.store._x.shape[0]
        eb = qg._dev_blocks()[1].shape[1]
        # the reference's width rule at this capacity and packed width
        budget = int(PQ4_BLOCK_GB * (1 << 30)) // (cap * qg.codes.shape[1])
        want_eb = min(idx.graph.e_max, max(max(8, min(16, budget)), budget))
        log(f"pq4 route: mode {qg.mode}, {qg.pq.m} subspaces of {qg.pq.ksub} centroids, "
            f"packed codes {qg.codes.shape[1]} bytes a row, capacity {cap}, eb {eb} of "
            f"{idx.graph.e_max} (the width rule gives {want_eb}), refine "
            f"{qg._resolve_refine(idx.graph.e_max, eb)}")
        if eb != want_eb:
            raise AssertionError(f"pq4 blocks are {eb} wide, the width rule gives {want_eb}")
        rec = BF.recall_at_k(found, gt, 10)
        once = sum(QG.last_profile.get(st, 0.0) for st in ("quantize", "blocks"))
        log(f"pq4 route: recall@10 {rec:.4f} at epsilon 0.1 (phase 7's sq8: {sq8_rec:.4f}), "
            f"{len(held) / secs:.0f} queries/s in one chunk of {len(held)} ({secs:.2f} s, "
            f"{graph_search.steps} steps; {len(held) / max(secs - once, 1e-9):.0f} queries/s "
            f"without the quantize and block gather) on {kind}; where the time went:")
        for label in ("fit", "encode"):
            sec = QG.last_profile.get(label, 0.0)
            log(f"  quantize, {label}: {sec * 1e3:.1f} ms")
        qg_split(secs, 1)
        if rec < PQ4_RECALL_FLOOR:
            raise AssertionError(f"pq4 recall@10 {rec:.4f} below {PQ4_RECALL_FLOOR}")
        os.environ.pop("NGT_TPU_QG_PROFILE")
        t0 = time.time()
        qg.save(os.path.join(tmp, "pq4"))
        qg2 = QG.QuantizedGraphIndex.open(os.path.join(tmp, "pq4"), device=dev)
        mine = qg.batch_search(base[sel], size=10, epsilon=0.1)[0]
        again = qg2.batch_search(base[sel], size=10, epsilon=0.1)[0]
        same = bool(np.array_equal(again, mine)) and qg2.mode == "pq4"
        log(f"pq4 route: save + open + search of {len(sel)} rows: {time.time() - t0:.1f} s; "
            f"identical ids: {same}")
        if not same:
            raise AssertionError("pq4 results changed across QuantizedGraphIndex.save/open")
        qg2.index.close()
        idx.close()
    finally:
        restore()


def ivfpq_crossover(path: str, base: np.ndarray, held: np.ndarray, gt: np.ndarray,
                    sel: np.ndarray, hits8: int, dev, kind: str, tmp: str) -> None:
    """Phase 17: phase 9's save opened afresh under NGT_TPU_QG_MAX_GB=1,
    past the qg size ceiling: batch_search builds and serves the auto
    IVFPQ mirror (recall@10 above IVFPQ_RECALL_FLOOR, ``verify() == []``,
    save + open identical); 1,000 removals rebuild it and no removed id
    comes back; then ``optimize_seeds`` and the exact route's self-hits of
    phase 8's rows (printed)."""
    import ngt_tpu_torch
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    restore = stage_env(NGT_TPU_QG_MAX_GB=str(IVFPQ_MAX_GB))
    try:
        idx = ngt_tpu_torch.open_index(path, device=dev)
        idx.prop.search_mode = "auto"
        t0 = time.time()
        found, _ = idx.batch_search(held, size=10)
        first = time.time() - t0
        ivf = idx._ivfpq_mirror
        if idx._qg is not None or ivf is None:
            raise AssertionError("batch_search did not take the IVFPQ mirror past the ceiling")
        tm = ivf.timings
        log(f"ivfpq crossover: first call of {len(held)} queries (mirror build + search) "
            f"{first:.2f} s; {len(ivf.centroids)} centroids, raw store {ivf.raw_store}, "
            f"longest bucket chain {ivf._device()['cent_buckets'].shape[1]}; build (s): "
            + ", ".join(f"{k} {tm.get(k, 0.0):.3f}" for k in
                        ("kmeans", "pq_fit", "assign_encode", "host_blocks", "upload")))
        t0 = time.time()
        found, _ = idx.batch_search(held, size=10)
        secs = time.time() - t0
        rec = BF.recall_at_k(found, gt, 10)
        log(f"ivfpq crossover: recall@10 {rec:.4f} at nprobe 32, expansion 16, refine; "
            f"{len(held) / secs:.0f} queries/s ({len(held)} in {secs:.2f} s) on {kind}")
        if rec < IVFPQ_RECALL_FLOOR:
            raise AssertionError(f"ivfpq recall@10 {rec:.4f} below {IVFPQ_RECALL_FLOOR}")
        problems = ivf.verify()
        t0 = time.time()
        ivf.save(os.path.join(tmp, "ivf"))
        ivf2 = IVFPQIndex.open(os.path.join(tmp, "ivf"), device=dev)
        kw = dict(size=10, nprobe=32, result_expansion=16.0)
        same = bool(np.array_equal(ivf.batch_search(held[:1000], **kw)[0],
                                   ivf2.batch_search(held[:1000], **kw)[0]))
        log(f"ivfpq crossover: verify() {problems}; save + open + search: "
            f"{time.time() - t0:.1f} s; identical ids: {same}")
        if problems or not same:
            raise AssertionError("the IVFPQ mirror failed verify or changed across save/open")
        del ivf2
        rng = np.random.default_rng(SEED + 10)
        gone = rng.choice(np.setdiff1d(np.arange(len(base)), sel), 1000, replace=False)
        idx.batch_remove(gone)
        t0 = time.time()
        again, _ = idx.batch_search(held, size=10)
        secs = time.time() - t0
        rebuilt = idx._ivfpq_mirror is not ivf and idx._ivfpq_mirror.live_size == len(base) - 1000
        leaked = int(np.isin(again, gone).sum())
        log(f"ivfpq crossover: after batch_remove of 1,000 ids the next call took {secs:.2f} s; "
            f"mirror rebuilt: {rebuilt}; removed ids served: {leaked}; recall@10 "
            f"{BF.recall_at_k(again, gt, 10):.4f} against the ground truth before the removals")
        if not rebuilt or leaked:
            raise AssertionError("the IVFPQ mirror was not rebuilt or served a removed id")
        del ivf
        idx.prop.search_mode = "exact"
        hits0 = int((idx.batch_search(base[sel], size=10)[0][:, 0] == sel).sum())
        t0 = time.time()
        idx.optimize_seeds()
        torch.cuda.synchronize()
        secs = time.time() - t0
        hits1 = int((idx.batch_search(base[sel], size=10)[0][:, 0] == sel).sum())
        log(f"optimize_seeds: {secs:.2f} s, {idx.seeder.num_reps} reps; exact-route self-hits "
            f"of phase 8's {len(sel)} rows: {hits1} after it, {hits0} before it on this "
            f"index, {hits8} in phase 8 (printed only)")
        idx.close()
    finally:
        restore()


def quant_card_vs_cpu(dev, n: int = 8192, nq: int = 1000) -> None:
    """Phase 18: at 8,192 rows (the phase 11 generator), the pq4 qg route
    with codebooks fitted on the card and carried to the CPU port (packed
    codes byte-equal, ids on >= 99.9% of entries), an IVFPQIndex built on
    the card and carried to the CPU in the approx, refine and exact modes
    and with the raw rows in an mmap file (ids on >= 99.9% of entries), and
    k-means from one host-drawn init on both (MSE within 1%)."""
    import ngt_tpu_torch
    from ngt_tpu_torch import convert
    from ngt_tpu_torch.quant import clustering as TC
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex
    from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

    t_all = time.time()
    x = sift_proxy(n + nq, seed=SEED + 1, kc=64)
    q = x[n:]
    restore = stage_env(NGT_TPU_QG_BLOCK_GB="0.001")
    try:
        card = ngt_tpu_torch.create(None, dimension=DIM, device=dev, search_mode="qg")
        card.batch_insert(x[:n], build=True)
        card.batch_search(q[:8], size=10)
        cq = card._qg
        if cq is None or cq.mode != "pq4":
            raise AssertionError("the card did not quantize to pq4 under the tight budget")
        cpu = convert.from_ngt_tpu_arrays(device="cpu", **convert.to_numpy_state(card))
        cpu._qg = QuantizedGraphIndex.encode_pq4(
            cpu, convert.pq_from_state(cq.pq.state_dict(), device="cpu"))
        cq.block_edges = cpu._qg.block_edges = 16
        codes_same = bool(np.array_equal(cq._host_codes()[: n + 1],
                                         cpu._qg._host_codes()[: n + 1]))
        gi, gd = card.batch_search(q, size=10, epsilon=0.1)
        ci, cd = cpu.batch_search(q, size=10, epsilon=0.1)
        same = gi == ci
        log(f"card vs CPU, pq4 qg route at {n} rows (codebooks fitted on the card, eb 16): "
            f"packed codes byte-equal {codes_same}, ids agree on {same.mean():.6f} of entries")
        if not codes_same or same.mean() < 0.999 or not np.allclose(gd[same], cd[same],
                                                                       rtol=1e-5):
            raise AssertionError("card and CPU disagree on the pq4 qg route")
        card.close()
    finally:
        restore()
    ivf = IVFPQIndex(DIM, n_centroids=64, device=dev)
    ivf.batch_insert(x[:n])
    ivf.build()
    st = convert.ivfpq_state(ivf)
    tmp = tempfile.mkdtemp(prefix="ngt_tpu_torch_ivf_")
    try:
        pairs = [("device", ivf, convert.ivfpq_from_state(device="cpu", **st))]
        st.update(raw_store="mmap", raw_path=os.path.join(tmp, "card.f32"))
        card_m = convert.ivfpq_from_state(device=dev, **st)
        st.update(raw_path=os.path.join(tmp, "cpu.f32"))
        pairs.append(("mmap", card_m, convert.ivfpq_from_state(device="cpu", **st)))
        for store, a, b in pairs:
            for mode in (("approx", "refine", "exact") if store == "device" else ("refine",)):
                ai, ad = a.batch_search(q, size=10, nprobe=16, mode=mode)
                bi, bd = b.batch_search(q, size=10, nprobe=16, mode=mode)
                same = ai == bi
                log(f"card vs CPU, IVFPQIndex at {n} rows, raw {store}, mode {mode}: ids agree "
                    f"on {same.mean():.6f} of entries")
                if same.mean() < 0.999 or not np.allclose(ad[same], bd[same], rtol=1e-5):
                    raise AssertionError(f"card and CPU disagree on IVFPQ ({store}, {mode})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    init = x[np.sort(np.random.default_rng(SEED + 11).choice(n, 256, replace=False))]
    mse = []
    for d in (dev, "cpu"):
        c, a = TC.kmeans(x[:n], 256, iters=15, init=init, device=d)
        mse.append(TC.mean_squared_error(x[:n], c, a))
    log(f"card vs CPU, k-means of {n} rows, k 256, 15 iterations from one host-drawn init: "
        f"MSE {mse[0]:.4f} on the card, {mse[1]:.4f} on the CPU")
    if abs(mse[0] - mse[1]) > 0.01 * mse[1]:
        raise AssertionError("card and CPU k-means MSE differ by more than 1%")
    log(f"card vs CPU, quantization: {time.time() - t_all:.1f} s")


def mutations_card_vs_cpu(dev, n: int = 8192, nq: int = 1000) -> float:
    """Phase 15: the mutation paths on the card and on the CPU port from the
    same rows (the phase 11 generator): bulk build, an append through
    build_anng, a batch removal, a bulk append; adjacency and exact-route
    ids on >= 99.9% of entries after each step.  Returns its seconds."""
    import ngt_tpu_torch

    t0 = time.time()
    x = sift_proxy(n + 2048 + 4096 + nq, seed=SEED + 1, kc=64)
    q = x[-nq:]
    gone = np.random.default_rng(SEED + 9).choice(n + 2048, 512, replace=False)
    steps = [
        ("bulk build", lambda i: i.batch_insert(x[:n], build=True)),
        ("build_anng append of 2048", lambda i: i.batch_insert(x[n : n + 2048], build=True)),
        ("batch_remove of 512", lambda i: i.batch_remove(gone)),
        ("bulk append of 4096", lambda i: i.batch_insert(x[n + 2048 : n + 6144], build=True)),
    ]
    pair = [ngt_tpu_torch.create(None, dimension=DIM, device=d, search_mode="exact")
            for d in (dev, "cpu")]
    for what, step in steps:
        for idx in pair:
            step(idx)
        card, cpu = pair
        m = card.store.repository_size
        adj = float((card.graph.nbr_ids[:m] == cpu.graph.nbr_ids[:m]).mean())
        ids = float((card.batch_search(q, size=10)[0] == cpu.batch_search(q, size=10)[0]).mean())
        log(f"card vs CPU, {what} at {card.store.repository_size - 1} slots: adjacency "
            f"{adj:.6f}, exact-route ids {ids:.6f}")
        if adj < 0.999 or ids < 0.999 or card.verify() or cpu.verify():
            raise AssertionError(f"card and CPU disagree after the {what}")
    for idx in pair:
        idx.close()
    secs = time.time() - t0
    log(f"card vs CPU, mutation paths: {secs:.1f} s")
    return secs


def u8_rows(allx: np.ndarray) -> np.ndarray:
    """The proxy scaled and rounded to integers in 0..255, in float32."""
    return np.rint(allx * np.float32(255.0 / float(allx.max()))).astype(np.float32)


def u8_arm(u: np.ndarray, dev, kind: str) -> int:
    """Phase 10: the proxy's integer rows (``u8_rows``), built and searched
    with default properties: the narrow mirror is u8, the codes ARE that
    tensor (scale 1.0), recall at the qg floor.  Returns the arm's
    window-scan launches."""
    import ngt_tpu_torch
    from ngt_tpu_torch.ops import traverse as TV
    from ngt_tpu_torch.ops import window_scan as WS

    base, held = u[:N_BASE], u[N_BASE : N_BASE + N_U8_Q]
    WS.window_scan.launches = 0
    t0 = time.time()
    idx = ngt_tpu_torch.create(None, dimension=DIM, device=dev)
    idx.batch_insert(base, build=True)
    torch.cuda.synchronize()
    log(f"u8 arm: build of {len(base)} x {DIM} integers in 0..255: {time.time() - t0:.1f} s")
    gt = ground_truth(idx, held)
    TV.traverse.launches = 0
    t0 = time.time()
    idx.batch_search(held[:512], size=10, epsilon=0.1)
    torch.cuda.synchronize()
    log(f"u8 arm: first call (codes + blocks + 512 queries) {time.time() - t0:.2f} s")
    check_qg_route(idx, torch.uint8)
    qg, mirror = idx._qg, idx._mirror
    shares = (qg._dev_codes().untyped_storage().data_ptr()
              == mirror.x.untyped_storage().data_ptr())
    log(f"u8 arm: codes share the mirror's storage: {shares}; sq_scale {qg.sq_scale!r}")
    if not shares or qg.sq_scale != 1.0:
        raise AssertionError("u8-exact codes are not the mirror tensor at scale 1.0")
    rec, _ = recall_run(lambda q: idx.batch_search(q, size=10, epsilon=0.1), held, gt,
                        "u8 arm, qg route", kind)
    if rec < QG_RECALL_FLOOR:
        raise AssertionError(f"u8 qg recall@10 {rec:.4f} below {QG_RECALL_FLOOR}")
    traverse_launches("u8 arm: qg search on uint8 blocks (phase 10)", dev)
    launches = WS.window_scan.launches
    if launches == 0:
        raise AssertionError("the u8 build never launched the window-scan kernel")
    idx.close()
    return launches


def card_vs_cpu(dev, n: int = 8192, nq: int = 1000) -> None:
    """Phase 11: the qg route on the card and on the CPU over one graph
    (built on the card, carried to the CPU by convert.py), in the exact and
    the lossy visited regime: codes and scale equal exactly, ids on
    >= 99.9% of entries (only the float reduction order differs)."""
    import ngt_tpu_torch
    from ngt_tpu_torch import convert

    x = sift_proxy(n + nq, seed=SEED + 1, kc=64)
    card = ngt_tpu_torch.create(None, dimension=DIM, device=dev, search_mode="qg")
    card.batch_insert(x[:n], build=True)
    cpu = convert.from_ngt_tpu_arrays(device="cpu", **convert.to_numpy_state(card))
    q = x[n:]
    for bits in (0, 10):
        card.prop.visited_bits_log2 = cpu.prop.visited_bits_log2 = bits
        gi, gd = card.batch_search(q, size=10, epsilon=0.1)
        ci, cd = cpu.batch_search(q, size=10, epsilon=0.1)
        # the converted index holds exactly its rows, the built one 2^k
        codes_same = bool(np.array_equal(card._qg._host_codes()[: n + 1],
                                         cpu._qg._host_codes()[: n + 1]))
        same = gi == ci
        regime = "lossy" if bits else "exact"
        log(f"card vs CPU, qg route at {n} rows, {regime} visited table: ids agree on "
            f"{same.mean():.6f} of entries, {same.all(1).mean():.4f} of queries wholly; "
            f"codes equal {codes_same}, scale equal {card._qg.sq_scale == cpu._qg.sq_scale}")
        if same.mean() < 0.999 or not codes_same or card._qg.sq_scale != cpu._qg.sq_scale:
            raise AssertionError(f"card and CPU disagree on the qg route ({regime})")
        if not np.allclose(gd[same], cd[same], rtol=1e-5):
            raise AssertionError("card and CPU distances differ")
    card.close()


def cosine_arm(dev, kind: str) -> int:
    """Phase 12: the 1M Cosine arm of bench.py's angular protocol.  Returns
    the window-scan launches of its build."""
    import ngt_tpu_torch
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import traverse as TV
    from ngt_tpu_torch.ops import window_scan as WS
    from ngt_tpu_torch.quant import qgraph as QG

    t0 = time.time()
    data = glove_proxy(N_GLOVE)
    qi = np.random.default_rng(23).choice(N_GLOVE, N_GLOVE_Q, replace=False)
    queries = data[qi]
    log(f"cosine arm: glove_proxy {N_GLOVE} x {GLOVE_DIM} in {time.time() - t0:.1f} s, "
        f"{N_GLOVE_Q} corpus rows as queries")
    os.environ["NGT_TPU_BUILD_PROFILE"] = "1"
    WS.window_scan.launches = 0
    t0 = time.time()
    idx = ngt_tpu_torch.create(None, dimension=GLOVE_DIM, distance_type="Cosine",
                               edge_size_for_creation=40, device=dev)
    idx.batch_insert(data, build=True)
    torch.cuda.synchronize()
    launches = WS.window_scan.launches
    del os.environ["NGT_TPU_BUILD_PROFILE"]
    log(f"cosine arm: build of {N_GLOVE} x {GLOVE_DIM} (Cosine, edge_size_for_creation 40): "
        f"{time.time() - t0:.1f} s; window_scan launches on this arm {launches}")
    log("cosine arm: build phases (s): " + ", ".join(
        f"{label} {sec:.3f}" for label, sec in TB.last_profile))
    if launches == 0:
        raise AssertionError("the Cosine build never launched the window-scan kernel")

    edge_agreement(idx, data, "cosine arm")
    problems = idx.verify()
    if problems:
        raise AssertionError(f"cosine verify: {problems}")
    gt = strip_self(np.concatenate([
        idx.batch_linear_search(queries[i : i + 2048], size=11)[0]
        for i in range(0, N_GLOVE_Q, 2048)
    ]), qi)

    # the qg route of default properties at epsilon 0.02, stage timer on
    os.environ["NGT_TPU_QG_PROFILE"] = "1"
    QG.last_profile.clear()
    graph_search.steps = 0
    trace.clear()
    TV.traverse.launches = 0
    t0 = time.time()
    found, _ = idx.batch_search(queries, size=11, epsilon=0.02)
    secs = time.time() - t0
    del os.environ["NGT_TPU_QG_PROFILE"]
    traverse_launches("Cosine arm: qg search (phase 12)", dev)
    qg = idx._qg
    if qg is None or qg.mode != "sq8":
        raise AssertionError("the Cosine search did not take the sq8 qg route")
    eb = qg._dev_blocks()[1].shape[1]
    codes = qg._dev_codes()
    normalized = QG._normalizes(idx.store.metric)
    log(f"cosine arm: qg route: mode {qg.mode}, codes {str(codes.dtype)}, scale "
        f"{qg.sq_scale!r} (x 127 = {qg.sq_scale * 127:.6f}), eb {eb} of {idx.graph.e_max}, "
        f"refine {qg._resolve_refine(idx.graph.e_max, eb)}, codes from row-normalized rows "
        f"and normalized traversal queries: {normalized}")
    if not normalized or codes.dtype != torch.int8 or qg.sq_scale * 127 > 1.0 + 1e-6:
        raise AssertionError("the Cosine qg codes are not the sq8 codes of unit rows")
    rec = BF.recall_at_k(strip_self(found, qi), gt, 10)
    once = sum(QG.last_profile.get(s, 0.0) for s in ("quantize", "blocks"))
    log(f"cosine arm: qg route recall@10 {rec:.4f} at epsilon 0.02, {N_GLOVE_Q / secs:.0f} "
        f"queries/s ({secs:.2f} s, {graph_search.steps} steps; "
        f"{N_GLOVE_Q / max(secs - once, 1e-9):.0f} queries/s without the one-time quantize "
        f"and block gather) on {kind}; where the time went:")
    qg_split(secs, -(-N_GLOVE_Q // 512))
    if rec < COSINE_QG_RECALL_FLOOR:
        raise AssertionError(f"cosine qg recall@10 {rec:.4f} below {COSINE_QG_RECALL_FLOOR}")
    idx.prop.search_mode = "exact"
    graph_search.steps = 0
    t0 = time.time()
    found, _ = idx.batch_search(queries, size=11, epsilon=0.02)
    secs = time.time() - t0
    log(f"cosine arm: exact route recall@10 {BF.recall_at_k(strip_self(found, qi), gt, 10):.4f} "
        f"at epsilon 0.02, {N_GLOVE_Q / secs:.0f} queries/s ({secs:.2f} s, "
        f"{graph_search.steps} steps) on {kind}")
    onng_arm(idx, queries, qi, gt, dev, kind)
    idx.close()
    return launches


def onng_bounds(n: int, w_src: int, pairs: int, e: int, e_max: int, lookups: int) -> dict:
    """The least time (ms) each ONNG program could take on one H100 for this
    run's sizes, the larger of its bytes over PEAK_BYTES and its compares and
    index operations over PEAK_CUDA_CORE, with the bound's name: reconstruct
    (read the source rows of width w_src, three sorts of the pairs and the
    distance lookup, write the rows), detect (read the rows, one binary
    search over e ids and five compares per (u, v, w), write the packed
    candidates), phase2 (read rows and candidates, a mask pass over [n, e] per
    rank and one global binary search per lookup, write the kept mask), rows
    (read rows and mask, write the compacted rows)."""
    lg = lambda v: max(1, int(np.ceil(np.log2(max(v, 2)))))  # noqa: E731
    cand = n * e * ((e + 7) // 8)
    work = {
        "reconstruct": (n * w_src * 8 + n * e_max * 8 + 8 * n,
                        3 * pairs * lg(pairs) + 3 * n * w_src * lg(n * w_src)),
        "detect": (n * e * 8 + cand, n * e * e * (lg(e) + 5)),
        "phase2": (n * e * 4 + 4 * n + cand + n * e, 5 * n * e * e + lookups * lg(n * e)),
        "rows": (n * e * 9 + n * e_max * 8 + 4 * n, 3 * n * e),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_CUDA_CORE * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def onng_arm(idx, queries: np.ndarray, qi: np.ndarray, gt: np.ndarray, dev, kind: str) -> None:
    """Phase 19: bench.py's angular ONNG sub-arm on phase 12's 1M Cosine
    index, then its five search settings, the route checks and save/open."""
    import ngt_tpu_torch
    from ngt_tpu_torch.graph import reconstruct as R
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import window_scan as WS
    from ngt_tpu_torch.optimizer import GraphOptimizer
    from ngt_tpu_torch.properties import GraphType

    n = idx.store.repository_size
    anng = idx.graph
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    WS.window_scan.launches = 0
    restore = stage_env(NGT_TPU_BUILD_PROFILE="1")
    t0 = time.time()
    try:
        GraphOptimizer(out_edges=ONNG_OUT, in_edges=ONNG_IN, tune_parameters=False).execute(idx)
        torch.cuda.synchronize()
    finally:
        restore()
    secs = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    stages = dict(R.last_profile)
    lookups = R._adjust_phase2.lookups
    pre = R.reconstruct_graph(anng, n, ONNG_OUT, ONNG_IN, device=dev)
    pre_deg = R._rows_dev(pre, n, dev)[2].cpu().numpy()
    del pre
    e = int(pre_deg.max())
    use_dev, c = R._adjust_rule(n, e, None)
    log(f"onng arm: GraphOptimizer(out {ONNG_OUT}, in {ONNG_IN}, tune_parameters=False) on "
        f"phase 12's {n - 1}-row index: {secs:.1f} s on {kind}; stages (s): " + ", ".join(
            f"{label} {sec:.3f}" for label, sec in stages.items()))
    log(f"onng arm: peak card memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held "
        f"before); phase-2 rule {'device' if use_dev else 'host'} R({c}), e {e} before the "
        f"path adjustment; {lookups} detour lookups; window-scan launches during it "
        f"{WS.window_scan.launches}")
    deg_src = anng.degree[:n]
    pairs = int(np.minimum(deg_src, ONNG_OUT).sum() + np.minimum(deg_src, ONNG_IN).sum())
    bounds = onng_bounds(n, anng.e_max, pairs, e, idx.graph.e_max, lookups)
    for name, (bound, by) in bounds.items():
        calls = f"1 call of {e} rank passes" if name == "phase2" else "1 call"
        log(f"onng arm: K10 {name}: {calls}, {stages[name]:.3f} s, bound {bound:.3f} ms by {by}")
    slowest = max(bounds, key=lambda name: stages[name])
    log(f"onng arm: the slowest ONNG program is {slowest} ({stages[slowest]:.3f} s); the "
        f"programs took {sum(stages[name] for name in bounds):.1f} s together")

    deg = idx.graph.degree[:n]
    if idx.prop.graph_type != GraphType.ONNG or idx.graph.e_max != 136 or \
            idx.prop.max_edges != 136:
        raise AssertionError(f"onng arm: graph type {idx.prop.graph_type}, e_max "
                             f"{idx.graph.e_max}")
    low = deg < np.minimum(10, pre_deg)
    log(f"onng arm: degrees mean {deg[1:].mean():.2f} (before the path adjustment "
        f"{pre_deg[1:].mean():.2f}, the ANNG {deg_src[1:].mean():.2f}), max {deg.max()}, "
        f"rows below min(10, their degree before) {int(low.sum())}")
    if deg.max() > 136 or low.any():
        raise AssertionError("onng arm: a degree outside [min(10, before), 136]")
    problems = idx.verify()
    if problems:
        raise AssertionError(f"onng arm verify: {problems}")

    idx.prop.search_mode = "auto"
    for ef, rexp, eps in ONNG_SETTINGS:
        old = idx.prop.result_expansion
        if rexp:
            idx.prop.result_expansion = rexp
        t0 = time.time()
        found, _ = idx.batch_search(queries, size=11, epsilon=eps, ef=ef)
        secs = time.time() - t0
        idx.prop.result_expansion = old
        rec = BF.recall_at_k(strip_self(found, qi), gt, 10)
        log(f"onng arm: ef {ef}, result_expansion {rexp or old}, epsilon {eps}: recall@10 "
            f"{rec:.4f}, {N_GLOVE_Q / secs:.0f} queries/s ({secs:.2f} s) on {kind}")
        if (ef, eps) == (0, 0.02):
            rec_002 = rec
    qg = idx._qg
    if qg is None or qg.mode != "sq8":
        raise AssertionError("onng arm: the search did not take the sq8 qg route")
    nbr_eb = qg._dev_blocks()[1]
    eb = nbr_eb.shape[1]
    same = bool(np.array_equal(nbr_eb[:n].cpu().numpy(), idx.graph.nbr_ids[:n, :eb]))
    log(f"onng arm: qg route mode {qg.mode}, eb {eb} of {idx.graph.e_max}, refine "
        f"{qg._resolve_refine(idx.graph.e_max, eb)}, blocks hold the ONNG's rows: {same}")
    if not same:
        raise AssertionError("onng arm: the qg blocks do not hold the ONNG's rows")
    if rec_002 < COSINE_QG_RECALL_FLOOR:
        raise AssertionError(f"onng arm: recall@10 {rec_002:.4f} at epsilon 0.02 below "
                             f"{COSINE_QG_RECALL_FLOOR}")
    tmp = tempfile.mkdtemp(prefix="ngt_tpu_torch_onng_")
    try:
        t0 = time.time()
        idx.save(tmp)
        re_idx = ngt_tpu_torch.open_index(tmp, device=dev)
        # the exact route: the qg route's block width follows the capacity,
        # 2^20 slots here and 1,000,001 once opened (eb 48 and 50)
        idx.prop.search_mode = re_idx.prop.search_mode = "exact"
        a = idx.batch_search(queries[:1024], size=11, epsilon=0.02)[0]
        b = re_idx.batch_search(queries[:1024], size=11, epsilon=0.02)[0]
        rows = bool(np.array_equal(re_idx.graph.nbr_ids[:n], idx.graph.nbr_ids[:n]))
        log(f"onng arm: save + open_index in {time.time() - t0:.1f} s: graph type "
            f"{re_idx.prop.graph_type.name}, e_max {re_idx.graph.e_max}, rows equal {rows}, "
            f"identical exact-route ids on 1,024 queries: {bool(np.array_equal(a, b))}")
        if re_idx.prop.graph_type != GraphType.ONNG or not rows or not np.array_equal(a, b):
            raise AssertionError("onng arm: the reopened ONNG differs")
        re_idx.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def onng_card_vs_cpu(dev, n: int = 8192, nq: int = 400) -> None:
    """Phase 20: the ONNG reconstruction on the card and on the CPU port
    from one bulk graph (the phase 11 generator, edge_size_for_creation 40):
    GraphOptimizer(10, 120, tune_parameters=True) under R(1) and R(8),
    reconstruct_graph_with_constraint and refine_anng."""
    import ngt_tpu_torch
    from ngt_tpu_torch import convert
    from ngt_tpu_torch.graph import reconstruct as R
    from ngt_tpu_torch.optimizer import GraphOptimizer, extract_queries

    t_all = time.time()
    x = sift_proxy(n + nq, seed=SEED + 1, kc=64)
    q = x[n:]
    m = n + 1

    def build():
        idx = ngt_tpu_torch.create(None, dimension=DIM, edge_size_for_creation=40, device=dev)
        idx.batch_insert(x[:n], build=True)
        return idx

    ref = build()
    state = convert.to_numpy_state(ref)
    ref.close()
    pre = convert.from_ngt_tpu_arrays(device="cpu", **state)
    pre_e = int(R._rows_dev(R.reconstruct_graph(pre.graph, m, ONNG_OUT, ONNG_IN, device="cpu"),
                            m, torch.device("cpu"))[2].max())
    # the tuning's queries, drawn once as extract_queries draws them: 64,
    # not 200, because the CPU's qg searches at epsilon 0.3-1.2 cost
    # seconds each (with 200 this phase outlasted all the others)
    q_tune = extract_queries(pre, 64)
    pre.close()

    def rows_equal(a, b, what: str) -> None:
        same = [np.array_equal(getattr(a, k)[:m], getattr(b, k)[:m])
                for k in ("nbr_ids", "degree", "nbr_dist")]
        log(f"card vs CPU, {what} at {n} rows: ids, degrees, distances equal {same}; "
            f"degree mean {a.degree[1:m].mean():.2f}")
        if not all(same):
            raise AssertionError(f"card and CPU disagree on {what}")

    def searches_agree(card, cpu, what: str, threshold: float = 0.999) -> None:
        # the tuned search edge size is the fastest one on each device
        log(f"card vs CPU, {what}: edge_size_for_search {card.prop.edge_size_for_search} on "
            f"the card, {cpu.prop.edge_size_for_search} on the CPU; both searched at the card's")
        cpu.prop.edge_size_for_search = card.prop.edge_size_for_search
        for mode in ("exact", "qg"):
            card.prop.search_mode = cpu.prop.search_mode = mode
            gi, gd = card.batch_search(q, size=10, epsilon=0.1)
            ci, cd = cpu.batch_search(q, size=10, epsilon=0.1)
            same = gi == ci
            log(f"card vs CPU, {what}: {mode}-route ids agree on {same.mean():.6f} of entries")
            if same.mean() < threshold or not np.allclose(gd[same], cd[same], rtol=1e-5):
                raise AssertionError(f"card and CPU disagree on the {mode} route after {what}")
        card.prop.search_mode = cpu.prop.search_mode = "auto"

    for rule, env in (("R(1)", {}), ("R(8)", {"NGT_TPU_ADJUST_DEVICE_MIN": "0"})):
        restore = stage_env(**env)
        try:
            card = build()
            dfr = card.graph._deferred
            if dfr is None or not np.array_equal(dfr[0][:m].cpu().numpy(), state["nbr_ids"]):
                raise AssertionError("the card build left no deferred rows equal to the copy's")
            cpu = convert.from_ngt_tpu_arrays(device="cpu", **state)
            times = []
            for idx in (card, cpu):
                if idx is cpu:
                    cpu.optimize_seeds = lambda num_reps=0: cpu.seeder.set_representatives(
                        card.seeder.rep_ids, cpu.store._x)
                t0 = time.time()
                GraphOptimizer(out_edges=ONNG_OUT, in_edges=ONNG_IN, tune_parameters=True,
                               queries=q_tune).execute(idx)
                times.append(time.time() - t0)
            use_dev, c = R._adjust_rule(m, pre_e, None)
            log(f"card vs CPU, GraphOptimizer(10, 120, tune_parameters=True) under {rule} "
                f"(picked: {'device' if use_dev else 'host'} rule, C {c}, e {pre_e} before "
                f"the path adjustment): {times[0]:.1f} s on the card, {times[1]:.1f} s on "
                "the CPU")
            rows_equal(card.graph, cpu.graph, f"the ONNG under {rule}")
            tables = (card.prop.accuracy_table, cpu.prop.accuracy_table)
            log(f"card vs CPU, accuracy table under {rule}: card {tables[0]}; equal "
                f"{tables[0] == tables[1]}")
            if tables[0] != tables[1] or not tables[0]:
                raise AssertionError(f"card and CPU accuracy tables differ under {rule}")
            searches_agree(card, cpu, f"the ONNG under {rule}")
            card.close()
            cpu.close()
        finally:
            restore()

    card = convert.from_ngt_tpu_arrays(device=dev, **state)
    cpu = convert.from_ngt_tpu_arrays(device="cpu", **state)
    rows_equal(R.reconstruct_graph_with_constraint(card.graph, m, ONNG_OUT, ONNG_IN, device=dev),
               R.reconstruct_graph_with_constraint(cpu.graph, m, ONNG_OUT, ONNG_IN,
                                                   device="cpu"),
               "reconstruct_graph_with_constraint")
    # refine on the exact route: its 8,192 searches cost the CPU a third of
    # the qg route's
    card.prop.search_mode = cpu.prop.search_mode = "exact"
    t0 = time.time()
    R.refine_anng(card, epsilon=0.02)
    t1 = time.time()
    R.refine_anng(cpu, epsilon=0.02)
    same = card.graph.nbr_ids[:m] == cpu.graph.nbr_ids[:m]
    log(f"card vs CPU, refine_anng at {n} rows: {t1 - t0:.1f} s on the card, "
        f"{time.time() - t1:.1f} s on the CPU; adjacency ids agree on {same.mean():.6f}")
    if same.mean() < 0.999:
        raise AssertionError("card and CPU disagree on refine_anng's rows")
    searches_agree(card, cpu, "refine_anng")
    card.close()
    cpu.close()
    log(f"card vs CPU, ONNG: {time.time() - t_all:.1f} s")


#: phase 13's indexes: every metric, and BFLOAT16 objects under L2
METRIC_CONFIGS = [
    ("L1", "Float"), ("L2", "Float"), ("Hamming", "Byte"), ("Angle", "Float"),
    ("Cosine", "Float"), ("Normalized Angle", "Float"), ("Normalized Cosine", "Float"),
    ("Jaccard", "Byte"), ("Sparse Jaccard", "Float"), ("Normalized L2", "Float"),
    ("Poincare", "Float"), ("Lorentz", "Float"), ("L2", "bfloat16"),
]


def metric_corpus(metric: str, rng, n: int, d: int) -> np.ndarray:
    """Clustered rows of the metric's domain: uint8 bit patterns (a few
    bits flipped from 32 centers) for Hamming and Jaccard, id sets drawn
    from 32 cluster vocabularies for sparse Jaccard, Poincare and Lorentz
    rows as tests/test_hyperbolic.py makes them, else f32 rows around 32
    centers with log-normal norms."""
    pick = rng.integers(0, 32, size=n)
    if metric in ("Hamming", "Jaccard"):
        centers = rng.integers(0, 256, (32, d)).astype(np.uint8)
        flips = np.packbits(rng.random((n, d, 8)) < 0.06, axis=-1)[..., 0]
        return centers[pick] ^ flips
    if metric == "Sparse Jaccard":
        from ngt_tpu_torch.store import pad_sparse

        pools = [rng.choice(8 * d, d, replace=False) for _ in range(32)]
        return pad_sparse([rng.choice(pools[c], rng.integers(4, d // 2), replace=False)
                           for c in pick], d)
    if metric == "Poincare":
        centers = rng.normal(size=(16, d))
        centers /= np.linalg.norm(centers, axis=1, keepdims=True) * 2.0
        x = centers[pick % 16] + rng.normal(size=(n, d)) * 0.08
        norm = np.linalg.norm(x, axis=1, keepdims=True)
        return np.where(norm > 0.85, x * (0.85 / norm), x).astype(np.float32)
    if metric == "Lorentz":
        centers = rng.normal(size=(16, d - 1)) * 0.6
        sp = centers[pick % 16] + rng.normal(size=(n, d - 1)) * 0.15
        return np.concatenate([np.sqrt(1.0 + (sp**2).sum(1, keepdims=True)), sp],
                              1).astype(np.float32)
    x = rng.normal(size=(32, d))[pick] + 0.5 * rng.normal(size=(n, d))
    return (x * rng.lognormal(0.0, 0.35, (n, 1))).astype(np.float32)


def metrics_card_vs_cpu(dev) -> None:
    """Phase 13: every metric and object type built and searched on the
    card and on the CPU port at N_METRIC rows: adjacency and exact-route
    ids on >= 99.9% of entries; the qg route's ids, scale and codes where
    it serves the metric."""
    import ngt_tpu_torch
    from ngt_tpu_torch.graph.build import _SQ8_METRICS

    n = N_METRIC
    for c, (metric, otype) in enumerate(METRIC_CONFIGS):
        t0 = time.time()
        x = metric_corpus(metric, np.random.default_rng(100 + c), n + N_METRIC_Q, METRIC_DIM)
        q = x[n:]
        pair = []
        for d in (dev, "cpu"):
            idx = ngt_tpu_torch.create(None, dimension=METRIC_DIM, distance_type=metric,
                                       object_type=otype, search_mode="exact", device=d)
            idx.batch_insert(x[:n], build=True)
            pair.append(idx)
        card, cpu = pair
        adj = float((card.graph.nbr_ids[: n + 1] == cpu.graph.nbr_ids[: n + 1]).mean())
        gi, gd = card.batch_search(q, size=10)
        ci, cd = cpu.batch_search(q, size=10)
        ids = float((gi == ci).mean())
        line = (f"card vs CPU, {metric} ({otype}) at {n} rows: adjacency {adj:.6f}, "
                f"exact-route ids {ids:.6f}")
        ok = adj >= 0.999 and ids >= 0.999
        if card.store.metric in _SQ8_METRICS:
            card.prop.search_mode = cpu.prop.search_mode = "qg"
            gi, _ = card.batch_search(q, size=10, epsilon=0.1)
            ci, _ = cpu.batch_search(q, size=10, epsilon=0.1)
            qids = float((gi == ci).mean())
            tc = card._qg._host_codes()[: n + 1].astype(np.int16)
            cc = cpu._qg._host_codes()[: n + 1].astype(np.int16)
            rel = abs(card._qg.sq_scale - cpu._qg.sq_scale) / cpu._qg.sq_scale
            same = float((tc == cc).mean())
            line += (f", qg-route ids {qids:.6f}, scale rel diff {rel:.2e}, codes equal "
                     f"{same:.6f} (most apart {int(np.abs(tc - cc).max())})")
            ok = ok and qids >= 0.999 and rel <= 1e-6 and same >= 0.9999 \
                and int(np.abs(tc - cc).max()) <= 1
        log(line + f"; {time.time() - t0:.1f} s")
        if not ok:
            raise AssertionError(f"card and CPU disagree for {metric} ({otype})")
        card.close()
        cpu.close()


def write_int_tsv(path: str, rows: np.ndarray, chunk: int = 65536) -> None:
    """Rows of integers in 0..255 as a TSV file, formatted by table lookup
    in numpy (np.savetxt takes minutes at 1M x 128)."""
    table = np.zeros((256, 4), np.uint8)   # up to 3 digits and a separator
    width = np.zeros(256, np.int64)
    for v in range(256):
        digits = str(v).encode()
        table[v, : len(digits)] = np.frombuffer(digits, np.uint8)
        width[v] = len(digits)
    with open(path, "wb") as fh:
        for s in range(0, len(rows), chunk):
            vals = rows[s : s + chunk].astype(np.int64)
            if vals.min() < 0 or vals.max() > 255:
                raise ValueError("write_int_tsv takes integers in 0..255")
            tok = table[vals]
            sep = np.full(vals.shape + (1,), ord("\t"), np.uint8)
            sep[:, -1] = ord("\n")
            np.put_along_axis(tok, width[vals][..., None], sep, axis=2)
            keep = np.arange(4)[None, None, :] <= width[vals][..., None]
            fh.write(tok[keep].tobytes())


def run_cli(argv: list[str]) -> tuple[str, float]:
    """``python -m ngt_tpu_torch <argv>`` in a subprocess from this
    checkout; returns its stdout and seconds, raises on a non-zero exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "ngt_tpu_torch", *argv], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    secs = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"ngt_tpu_torch {argv[0]} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    return proc.stdout, secs


def cli_arm(u: np.ndarray, tmp: str, dev, kind: str) -> tuple[int, str]:
    """Phase 21: the CLI at 1M (see the module docstring).  Returns the
    window-scan launches of ``create`` and the index directory."""
    import contextlib
    import io

    import ngt_tpu_torch
    from ngt_tpu_torch import cli
    from ngt_tpu_torch.ops import window_scan as WS

    base, held = u[:N_BASE], u[N_BASE:]
    tsv, qtsv, path = (os.path.join(tmp, name) for name in ("base.tsv", "queries.tsv", "index"))
    t0 = time.time()
    write_int_tsv(tsv, base)
    write_int_tsv(qtsv, held)
    log(f"CLI: TSV of {len(base)} x {DIM} integers written in {time.time() - t0:.1f} s, "
        f"{os.path.getsize(tsv)} bytes")

    # create, in-process so that the kernel's launch counter can be read
    WS.window_scan.launches = 0
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["create", "-d", str(DIM), "-D", "L2", path, tsv])
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = WS.window_scan.launches
    log(f"CLI: create of {len(base)} rows: {secs:.1f} s on {kind} (exit {rc}); its own "
        f"lines: {'; '.join(err.getvalue().strip().splitlines())}; window_scan launches "
        f"{launches}")
    if rc != 0 or launches == 0:
        raise AssertionError("the CLI's create failed or never launched the window-scan kernel")

    idx = ngt_tpu_torch.open_index(path, device=dev)
    problems = idx.verify()
    if problems:
        raise AssertionError(f"verify after the CLI's create: {problems}")
    log("CLI: the created index verifies")
    edge_agreement(idx, base, "CLI")

    # search, as a user runs it: a subprocess on the card
    out, secs = run_cli(["search", "-o", "e", "-n", "10", "-Q", str(N_CLI_Q), path, qtsv])
    stream = cli._parse_eval_stream(out)
    if list(stream) != [0.1] or sorted(stream[0.1]) != list(range(1, N_CLI_Q + 1)):
        raise AssertionError("the CLI's evaluation stream lacks queries")
    got = [stream[0.1][i][0] for i in range(1, N_CLI_Q + 1)]
    mean_ms = float(np.mean([stream[0.1][i][1] for i in range(1, N_CLI_Q + 1)]))
    mine = []
    for q in held[:N_CLI_Q]:
        ids, dists, _ = idx.batch_search(q[None], size=10, epsilon=0.1, with_stats=True)
        mine.append([int(i) + 1 for i, d in zip(ids[0], dists[0]) if i >= 0 and np.isfinite(d)])
    gt = idx.batch_linear_search(held[:N_CLI_Q], size=10)[0]
    rec = float(np.mean([len(set(g) & {i - 1 for i in f}) / 10 for f, g in zip(got, gt)]))
    log(f"CLI: search -o e -n 10 -Q {N_CLI_Q} (a subprocess): {secs:.1f} s for the command, "
        f"mean query {mean_ms:.3f} ms (the exact route), recall@10 {rec:.4f} against exact "
        f"ground truth; ids equal to in-process batch_search: {got == mine}")
    if got != mine:
        raise AssertionError("the CLI's ids differ from the in-process search's")
    if rec < CLI_RECALL_FLOOR:
        raise AssertionError(f"the CLI's recall@10 {rec:.4f} below {CLI_RECALL_FLOOR}")
    idx.close()
    return launches, path


def _digest(path: str) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        h = hashlib.sha256()
        with open(os.path.join(path, name), "rb") as fh:
            for block in iter(lambda: fh.read(1 << 24), b""):
                h.update(block)
        out[name] = h.hexdigest()
    return out


def export_import(path: str, queries: np.ndarray, tmp: str, dev, kind: str) -> None:
    """Phase 22: export and import at 1M, then the memory-mapped open (see
    the module docstring)."""
    import ngt_tpu_torch

    stream, copy = os.path.join(tmp, "export.bin"), os.path.join(tmp, "imported")
    _, ex_s = run_cli(["export", path, stream])
    size = os.path.getsize(stream)
    _, im_s = run_cli(["import", copy, stream])
    os.remove(stream)
    log(f"CLI: export of the {N_BASE}-row index {ex_s:.1f} s, {size} bytes "
        f"({size / ex_s / 1e6:.0f} MB/s); import {im_s:.1f} s (subprocesses, interpreter "
        "start included); the stream deleted")
    a = ngt_tpu_torch.open_index(path, device=dev)
    b = ngt_tpu_torch.open_index(copy, device=dev)
    n = a.store.repository_size
    pairs = {
        "objects": (a.store._x[:n], b.store._x[:n]),
        "valid": (a.store._valid[:n], b.store._valid[:n]),
        "free": (np.sort(a.store._free), np.sort(b.store._free)),
        "nbr_ids": (a.graph.nbr_ids[:n], b.graph.nbr_ids[:n]),
        "nbr_dist": (a.graph.nbr_dist[:n], b.graph.nbr_dist[:n]),
        "degree": (a.graph.degree[:n], b.graph.degree[:n]),
        "has_node": (a.graph._has_node[:n], b.graph._has_node[:n]),
        "rep_ids": (a.seeder.rep_ids, b.seeder.rep_ids),
    }
    equal = {k: bool(b.store.repository_size == n and np.array_equal(x, y))
             for k, (x, y) in pairs.items()}
    log(f"CLI: the imported index equals the exported one: {equal}")
    if not all(equal.values()):
        raise AssertionError(f"export -> import changed the index: {equal}")
    ids = {}
    for name, idx in (("exported", a), ("imported", b)):
        ids[name] = (idx.batch_search(queries, size=10)[0],
                     idx.batch_search(queries, size=10, with_stats=True)[0])
    same = [np.array_equal(x, y) for x, y in zip(ids["exported"], ids["imported"])]
    log(f"CLI: ids of {len(queries)} queries on the imported index equal the exported "
        f"one's: default route {same[0]}, exact route {same[1]}")
    if not all(same):
        raise AssertionError("the imported index answers differently")
    b.close()
    shutil.rmtree(copy)

    before = _digest(path)
    t0 = time.time()
    mm = ngt_tpu_torch.open_index(path, memory_mapped=True, device=dev)
    mm_ids = mm.batch_search(queries, size=10, with_stats=True)[0]
    mapped = isinstance(mm.store._x, np.memmap) and isinstance(mm.graph.nbr_ids, np.memmap)
    mm.remove(0)
    slot = mm.insert(queries[0])
    mm.build_index()
    found = mm.batch_search(queries[:1], size=1, with_stats=True)[0][0, 0]
    after = _digest(path)
    log(f"CLI: memory-mapped open + search + remove + insert + build: "
        f"{time.time() - t0:.1f} s; mapped {mapped}; exact-route ids equal to the plain "
        f"open's: {bool(np.array_equal(mm_ids, ids['exported'][1]))}; the insert took "
        f"freed slot {slot} and is found first: {found == slot}; files unchanged: "
        f"{after == before}")
    if not (mapped and np.array_equal(mm_ids, ids["exported"][1]) and slot == 0
            and found == slot and after == before):
        raise AssertionError("the memory-mapped open misbehaved")
    mm.close()
    a.close()


def _dedup_batch(store_idx, base: np.ndarray, fresh: np.ndarray, n_copy: int, n_new: int,
                 seed: int):
    """A dedup batch for ``store_idx`` (holding ``base``): ``n_copy`` base
    rows moved by +-1 on four coordinates (distance 2.0) whose nearest
    other base row lies farther than 6, and ``n_new`` of ``fresh`` farther
    than DEDUP_RADIUS + 2 from every stored row and than DEDUP_RADIUS from
    each other, shuffled.  Returns (batch, source id or -1 per row)."""
    from ngt_tpu_torch.ops import distances as D

    rng = np.random.default_rng(seed)
    dev = store_idx.device
    cand = rng.choice(len(base), min(len(base), 4 * n_copy), replace=False)
    _, d2 = store_idx.batch_linear_search(base[cand], size=2)
    src = cand[d2[:, 1] > 6.0][:n_copy]
    _, dn = store_idx.batch_linear_search(fresh, size=1)
    far = fresh[dn[:, 0] > DEDUP_RADIUS + 2.0]
    ft = torch.from_numpy(far).to(dev)
    close = (D.pairwise(store_idx.store.metric, ft, ft) <= DEDUP_RADIUS).cpu().numpy()
    keep = np.ones(len(far), bool)
    for i in range(len(far)):     # greedy: drop a row close to a kept one
        if keep[i]:
            keep[i + 1 :] &= ~close[i, i + 1 :]
    new = far[keep][:n_new]
    if len(src) < n_copy or len(new) < n_new:
        raise AssertionError(f"dedup batch: {len(src)} sources, {len(new)} new rows")
    noise = np.zeros((n_copy, DIM), np.float32)
    cols = np.argsort(rng.random((n_copy, DIM)), axis=1)[:, :4]
    np.put_along_axis(noise, cols, rng.choice([-1.0, 1.0], (n_copy, 4)).astype(np.float32), 1)
    batch = np.concatenate([base[src] + noise, new])
    source = np.concatenate([src, np.full(n_new, -1)])
    order = rng.permutation(len(batch))
    return batch[order], source[order]


def dedup_arm(path: str, u: np.ndarray, dev, kind: str) -> int:
    """Phase 23: ``batch_insert_dedup`` on the live 1M index, then card
    against CPU at 8,192 rows (see the module docstring).  Returns the
    window-scan launches of the dedup's bulk append."""
    import ngt_tpu_torch
    from ngt_tpu_torch.ops import distances as D
    from ngt_tpu_torch.ops import window_scan as WS

    base, held = u[:N_BASE], u[N_BASE:]
    idx = ngt_tpu_torch.open_index(path, device=dev)
    t0 = time.time()
    batch, source = _dedup_batch(idx, base, held, N_DEDUP_COPY, N_DEDUP_NEW, seed=5)
    log(f"dedup: batch of {len(batch)} rows chosen in {time.time() - t0:.1f} s")
    WS.window_scan.launches = 0
    t0 = time.time()
    ids, identical, dist = idx.batch_insert_dedup(batch, radius=DEDUP_RADIUS)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = WS.window_scan.launches
    copy, new = source >= 0, source < 0
    ok = {
        "copies identical": bool(identical[copy].all()),
        "copies' ids are their sources": bool((ids[copy] == source[copy]).all()),
        "copies at 2.0": bool((dist[copy] == 2.0).all()),
        "new rows inserted": bool((~identical[new]).all() and (dist[new] == 0).all()),
        "new ids fresh": bool(len(np.unique(ids[new])) == new.sum()
                              and (ids[new] >= N_BASE).all()),
        "size": len(idx) == N_BASE + int(new.sum()),
    }
    log(f"dedup of {len(batch)} rows (radius {DEDUP_RADIUS}) on the live {N_BASE}-row index: "
        f"{secs:.2f} s on {kind}, window_scan launches {launches} (the bulk append of "
        f"{int(new.sum())} rows); {ok}")
    problems = idx.verify()
    if not all(ok.values()) or launches == 0 or problems:
        raise AssertionError(f"dedup at 1M: {ok}, launches {launches}, verify {problems}")
    idx.close()

    # the card's sqrt against the correctly rounded one (the CPU port's)
    v = np.random.default_rng(1).random(1 << 20).astype(np.float32) * 1e4
    got = D.sqrt(torch.from_numpy(v).to(dev)).cpu().numpy()
    log(f"dedup: the card's float32 sqrt equals numpy's on {(got == np.sqrt(v)).mean():.6f} "
        "of 2^20 values")
    if not np.array_equal(got, np.sqrt(v)):
        raise AssertionError("the card's sqrt is not correctly rounded")

    # card against CPU at 8,192 rows, 1,000 copies and 1,000 new rows
    small = base[:N_DEDUP_SMALL]
    res = {}
    for where in (dev, torch.device("cpu")):
        sidx = ngt_tpu_torch.create(None, dimension=DIM, device=where)
        sidx.batch_insert(small, build=True)
        if where == dev:
            sbatch, _ = _dedup_batch(sidx, small, held, 1000, 1000, seed=6)
            # rows 4.0 from earlier batch rows: chains inside the batch
            later = sbatch[:50].copy()
            later[:, :16] += 1.0
            sbatch = np.concatenate([sbatch, later])
        t0 = time.time()
        # build=False: the decision under test does not read the graph, and
        # the CPU's incremental build of the inserted rows took 35 s
        res[where.type] = sidx.batch_insert_dedup(sbatch, radius=DEDUP_RADIUS, build=False)
        res[where.type + " s"] = time.time() - t0
        sidx.close()
    same = [np.array_equal(x, y) for x, y in zip(res[dev.type], res["cpu"])]
    log(f"card vs CPU, dedup of {len(sbatch)} rows into {N_DEDUP_SMALL}: "
        f"{res[dev.type + ' s']:.2f} s on the card, {res['cpu s']:.2f} s on the CPU; "
        f"ids, identical, dist equal {same}; {int(res['cpu'][1].sum())} identical")
    if not all(same):
        raise AssertionError("card and CPU disagree on batch_insert_dedup")
    return launches


def recall_of(found: np.ndarray, gt: np.ndarray) -> float:
    from ngt_tpu_torch.ops import bruteforce as BF

    return BF.recall_at_k(np.asarray(found), np.asarray(gt), 10)


def exact_gt(base: np.ndarray, queries: np.ndarray, dev, k: int = 10) -> np.ndarray:
    """Exact top-k row ids of ``queries`` over ``base`` on the card (the
    port's linear search in query chunks)."""
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.properties import DistanceType

    x = torch.from_numpy(base).to(dev)
    valid = torch.ones(len(base), dtype=torch.bool, device=dev)
    out = [BF.linear_search(torch.from_numpy(queries[i : i + 1000]).to(dev), x, valid,
                            DistanceType.L2, k)[0].cpu().numpy()
           for i in range(0, len(queries), 1000)]
    del x, valid
    return np.concatenate(out).astype(np.int64)


def sharded_arm(tmp: str, dev) -> int:
    """Phase 24: two 1M-row shards on the one card (see the module
    docstring).  Returns the window-scan launches of the sharded build."""
    import torch.distributed as dist

    import ngt_tpu_torch.index as TI
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.ops import traverse as TV
    from ngt_tpu_torch.ops import window_scan as WS
    from ngt_tpu_torch.parallel import multihost as MH
    from ngt_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQ
    from ngt_tpu_torch.parallel.sharding import ShardedIndex, ShardedQG, make_mesh
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    secs = {}
    t0 = time.time()
    allx = sift_proxy(N_SHARD + N_HELD_OUT, seed=SHARD_SEED)
    base, held = allx[:N_SHARD], allx[N_SHARD:]
    secs["data"] = time.time() - t0
    t0 = time.time()
    gt = exact_gt(base, held, dev)
    secs["ground truth"] = time.time() - t0

    # the sharded build: each shard's create + build_index, launches per shard
    mesh = make_mesh(2, device=dev.type)
    if [d.type for d in mesh.devices] != [dev.type, dev.type]:
        raise AssertionError(f"make_mesh(2) did not place both shards on the card: {mesh}")
    per_shard = []
    build_index = TI.Index.build_index

    def counted(self, *args, **kwargs):
        n0 = WS.window_scan.launches
        build_index(self, *args, **kwargs)
        torch.cuda.synchronize()
        per_shard.append(WS.window_scan.launches - n0)

    WS.window_scan.launches = 0
    TI.Index.build_index = counted
    t0 = time.time()
    try:
        sidx = ShardedIndex.build(base, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        TI.Index.build_index = build_index
    secs["build"] = time.time() - t0
    launches = WS.window_scan.launches
    n_local = sidx._sharded.n_local
    log(f"sharded: build of {N_SHARD} x {DIM} as 2 shards of {n_local} rows on {mesh}: "
        f"{secs['build']:.1f} s; window_scan launches per shard {per_shard} (245 expected "
        f"at 2^20 slots), {launches} in all; seeds per shard "
        f"{sidx._sharded.seed_ids_local.shape[1]}")
    if len(per_shard) != 2 or (dev.type == "cuda" and min(per_shard) == 0):
        raise AssertionError("a shard's build never launched the window-scan kernel")

    # batch_search of the first N_SHARD_Q held-out queries (a depth cut),
    # recall against the exact 2M search
    ns = N_SHARD_Q
    graph_search.steps = 0
    t0 = time.time()
    ids, dists = sidx.batch_search(held[:ns], size=10, epsilon=0.1)
    secs["search"] = time.time() - t0
    rec = recall_of(ids, gt[:ns])
    sorted_ok = bool((np.diff(dists, axis=1) >= 0).all())
    log(f"sharded: batch_search of {ns} queries at epsilon 0.1: recall@10 {rec:.4f}, "
        f"{ns / secs['search']:.0f} queries/s ({secs['search']:.2f} s, "
        f"{graph_search.steps} steps over both shards); rows sorted {sorted_ok}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if rec < SHARDED_RECALL_FLOOR or not sorted_ok:
        raise AssertionError(f"sharded recall@10 {rec:.4f} below {SHARDED_RECALL_FLOOR}")

    # the sharded sq8 quantized graph, blocks built on the card
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    qg = ShardedQG.from_sharded_index(sidx)
    torch.cuda.synchronize()
    secs["qg blocks"] = time.time() - t0
    on_card = all(p.device.type == dev.type for p in qg.blocks.parts + qg.codes.parts)
    nq = N_SHARD_QG_Q
    TV.traverse.launches = 0
    t0 = time.time()
    qi, _ = qg.search(torch.from_numpy(held[:nq]), k=10, epsilon=0.1)
    qi = qi.cpu().numpy()
    secs["qg search"] = time.time() - t0
    traverse_launches("sharded: ShardedQG search (phase 24)", dev)
    ext = np.where(qi >= 0, sidx.id_map[np.clip(qi, 0, None)], -1)
    qrec = recall_of(ext, gt[:nq])
    log(f"sharded: ShardedQG codes + blocks ({qg.eb} columns, scale {qg.sq_scale!r}) built "
        f"on {dev.type}: {on_card}, {secs['qg blocks']:.2f} s; search of {nq} queries at "
        f"epsilon 0.1: recall@10 {qrec:.4f}, {secs['qg search']:.2f} s; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not on_card or qrec < SHARDED_QG_RECALL_FLOOR:
        raise AssertionError(f"sharded qg recall@10 {qrec:.4f} below {SHARDED_QG_RECALL_FLOOR}")
    del qg
    torch.cuda.empty_cache()

    # the sharded IVFPQ over a port IVFPQIndex of the same rows
    t0 = time.time()
    ivf = IVFPQIndex(dimension=DIM, n_centroids=SHARD_IVF_CENTROIDS, dsub=2, ksub=16, device=dev)
    for i in range(0, N_SHARD, 1 << 20):
        ivf.batch_insert(base[i : i + (1 << 20)])
    ivf.build()
    torch.cuda.synchronize()
    secs["ivfpq build"] = time.time() - t0
    t0 = time.time()
    sh = ShardedIVFPQ(mesh, ivf)
    torch.cuda.synchronize()
    secs["ivfpq shard"] = time.time() - t0
    rep = sh.memory_report()
    loads = np.asarray(rep["shard_loads"])
    t0 = time.time()
    vi, vd = sh.batch_search(held, size=10, nprobe=SHARD_IVF_NPROBE,
                             result_expansion=SHARD_IVF_EXP)
    secs["ivfpq search"] = time.time() - t0
    vrec = recall_of(vi, gt)
    ok = vi >= 0
    true = np.sqrt(((held[:, None, :] - base[np.where(ok, vi, 0)]) ** 2).sum(-1,
                                                                           dtype=np.float64))
    exact = bool(np.allclose(vd[ok], true[ok], rtol=1e-4))
    log(f"sharded: ShardedIVFPQ ({SHARD_IVF_CENTROIDS} centroids, dsub 2, ksub 16; the "
        f"index built in {secs['ivfpq build']:.1f} s, sharded in {secs['ivfpq shard']:.1f} s): "
        f"memory_report {rep}; loads within 2x of the mean {bool(loads.max() <= 2 * loads.mean())}; "
        f"nprobe {SHARD_IVF_NPROBE}, expansion {SHARD_IVF_EXP}: recall@10 {vrec:.4f}, "
        f"{len(held) / secs['ivfpq search']:.0f} queries/s; distances exact {exact}")
    if (loads.max() > 2 * loads.mean() or loads.sum() != N_SHARD or not exact
            or vrec < SHARDED_IVFPQ_RECALL_FLOOR):
        raise AssertionError(f"sharded IVFPQ: loads {loads}, exact {exact}, recall {vrec:.4f}")
    del sh, ivf
    torch.cuda.empty_cache()

    # save_distributed -> open_distributed under a one-rank NCCL group
    path = os.path.join(tmp, "sharded")
    t0 = time.time()
    # one rank: the NCCL bootstrap needs no interface but the loopback
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    MH.initialize(f"file://{os.path.join(tmp, 'group_store')}", 1, 0, device=dev.type)
    try:
        gmesh = MH.make_global_mesh(2, device=dev.type)
        backend = dist.get_backend()
        sidx.save_distributed(path)
        files = sorted(os.listdir(path))
        again = ShardedIndex.open_distributed(path, gmesh)
        nr = N_SHARD_REOPEN_Q
        ids2, _ = again.batch_search(held[:nr], size=10, epsilon=0.1)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    secs["save + open + search"] = time.time() - t0
    same = bool(np.array_equal(ids2, ids[:nr]))
    log(f"sharded: save_distributed ({files}) -> open_distributed on {gmesh} "
        f"(backend {backend}) -> {nr} queries: ids equal to the in-memory search: {same}")
    if backend != ("nccl" if dev.type == "cuda" else "gloo") or not same:
        raise AssertionError("the reopened sharded index disagrees with the in-memory one")
    del sidx, again
    torch.cuda.empty_cache()
    log("sharded: seconds by stage: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return launches


def sharded_card_vs_cpu(dev, n: int = 8192, nq: int = 500) -> None:
    """Phase 25: the sharded programs on the card against the CPU port at
    8,192 rows, P = 2 (the phase 11 generator)."""
    from ngt_tpu_torch import convert
    from ngt_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQ
    from ngt_tpu_torch.parallel.sharding import (
        ShardedGraphIndex,
        ShardedIndex,
        ShardedQG,
        build_local_knng_shards,
        make_mesh,
        make_sharded_build_step,
        shard_host_index,
    )
    from ngt_tpu_torch.properties import DistanceType
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    t_all = time.time()
    x = sift_proxy(n + nq + N_STEP_ROWS, seed=SEED + 1, kc=64)
    base, q, extra = x[:n], x[n : n + nq], x[n + nq :]
    meshes = (make_mesh(2, device=dev.type), make_mesh(2, device="cpu"))

    def agree(a, b, what, threshold=0.999):
        share = float((a == b).mean())
        log(f"sharded card vs CPU, {what}: {share:.6f} of entries agree")
        if share < threshold:
            raise AssertionError(f"card and CPU disagree on {what}")
        return share

    card, cpu = (ShardedIndex.build(base, mesh=m) for m in meshes)
    sc, sp = card._sharded, cpu._sharded
    if not np.array_equal(sc.x.numpy(), sp.x.numpy()) or not np.array_equal(
            sc.valid.numpy(), sp.valid.numpy()):
        raise AssertionError("the card's and the CPU's shard rows differ")
    agree(sc.nbr.numpy(), sp.nbr.numpy(), f"ShardedIndex.build adjacency at {n} rows")
    agree(card.batch_search(q, size=10)[0], cpu.batch_search(q, size=10)[0],
          "ShardedIndex.batch_search ids")

    # ShardedQG from one set of host arrays on both: codes and blocks byte-equal
    nl = sp.n_local
    arrays = (sp.x.numpy().reshape(2, nl, -1), sp.nbr.numpy().reshape(2, nl, -1),
              sp.valid.numpy().reshape(2, nl), sp.seed_ids_local.numpy())
    qgs = [ShardedQG(m, *arrays, DistanceType.L2) for m in meshes]
    same = (qgs[0].sq_scale == qgs[1].sq_scale
            and np.array_equal(qgs[0].codes.numpy(), qgs[1].codes.numpy())
            and np.array_equal(qgs[0].blocks.numpy(), qgs[1].blocks.numpy()))
    log(f"sharded card vs CPU, ShardedQG: scale, codes and blocks byte-equal {same}")
    if not same:
        raise AssertionError("the card's sq8 codes or blocks differ from the CPU's")
    qq = torch.from_numpy(q)
    agree(*(g.search(qq, k=10, epsilon=0.1)[0].cpu().numpy() for g in qgs), "ShardedQG ids")
    del qgs

    # ShardedIVFPQ: one IVFPQIndex (built on the CPU), carried to the card
    ivf = IVFPQIndex(dimension=DIM, n_centroids=64, dsub=2, ksub=16, device="cpu")
    ivf.batch_insert(base)
    ivf.build()
    card_ivf = convert.ivfpq_from_state(device=dev, **convert.ivfpq_state(ivf))
    shs = (ShardedIVFPQ(meshes[0], card_ivf), ShardedIVFPQ(meshes[1], ivf))
    agree(*(s.batch_search(q, size=10, nprobe=8, result_expansion=3.0)[0] for s in shs),
          "ShardedIVFPQ ids")

    # 4 build steps of N_STEP_ROWS / 4 rows into free slots (the spare rows
    # shard_host_index lays out invalid), from one exact per-shard KNNG
    m_all = n + N_STEP_ROWS
    xh = np.zeros((m_all, DIM), np.float32)
    xh[:n] = base
    vh = np.arange(m_all) < n
    x_s, _, _, val_s, n_local = shard_host_index(xh, np.full((m_all, 1), -1, np.int32), vh, 2)
    nbr_s, nbrd_s = build_local_knng_shards(x_s, val_s, 16, DistanceType.L2)
    seeds = np.arange(64, dtype=np.int32)
    idxs = [ShardedGraphIndex(m, x_s, nbr_s, val_s, seeds, DistanceType.L2,
                              nbr_dist_shards=nbrd_s) for m in meshes]
    steps = [make_sharded_build_step(m, DistanceType.L2, 10, n_local, width=32) for m in meshes]
    state = [(i.x, i.nbr, i.nbr_dist, i.valid) for i in idxs]
    per = N_STEP_ROWS // 4
    nn = [[], []]
    for s in range(4):
        j = np.arange(per)
        gids = ((j % 2) * n_local + n // 2 + s * per // 2 + j // 2).astype(np.int32)
        newx = extra[s * per : (s + 1) * per]
        for c in range(2):
            out = steps[c](*state[c], newx, gids, idxs[c].seed_ids_local)
            state[c] = tuple(out[:4])
            nn[c].append(out.new_neighbor_ids.cpu().numpy())
    agree(np.concatenate(nn[0]), np.concatenate(nn[1]), "build steps' new neighbor ids")
    agree(state[0][1].numpy(), state[1][1].numpy(), "build steps' nbr")
    nd = [st[2].numpy() for st in state]
    agree(np.isclose(nd[0], nd[1], rtol=1e-5), True, "build steps' nbr_dist (within 1e-5)")
    agree(state[0][3].numpy(), state[1][3].numpy(), "build steps' valid", threshold=1.0)
    log(f"sharded card vs CPU: {time.time() - t_all:.1f} s")


#: phase 26's C program: NGT's C API over the port's library with the
#: default device, at the sizes of the JAX package's C test, then the 1M
#: index of phase 21: 50 searches whose ids it prints
SMOKE_C = r"""
#include <math.h>
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
typedef void *NGTIndex;
typedef void *NGTProperty;
typedef void *NGTObjectSpace;
typedef void *NGTObjectDistances;
typedef void *NGTError;
typedef void *NGTOptimizer;
typedef void *NGTQGIndex;
typedef uint32_t ObjectID;
typedef struct { ObjectID id; float distance; } NGTObjectDistance;
typedef struct { float *query; size_t size; float epsilon; float accuracy; float radius; size_t edge_size; } NGTQuery;
typedef struct { size_t no_of_queries; size_t no_of_results; size_t no_of_threads; float target_accuracy;
                 size_t target_no_of_objects; size_t no_of_sample_objects; size_t max_of_no_of_edges; bool log; }
    NGTAnngEdgeOptimizationParameter;
typedef struct { float *query; size_t size; float epsilon; float result_expansion; float radius; } NGTQGQuery;
typedef struct { float dimension_of_subvector; size_t max_number_of_edges; } NGTQGQuantizationParameters;
extern NGTError ngt_create_error_object(void);
extern const char *ngt_get_error_string(const NGTError);
extern void ngt_clear_error_string(NGTError);
extern void ngt_destroy_error_object(NGTError);
extern NGTProperty ngt_create_property(NGTError);
extern bool ngt_set_property_dimension(NGTProperty, int32_t, NGTError);
extern bool ngt_set_property_edge_size_for_creation(NGTProperty, int16_t, NGTError);
extern bool ngt_set_property_edge_size_for_search(NGTProperty, int16_t, NGTError);
extern bool ngt_set_property_distance_type_l2(NGTProperty, NGTError);
extern bool ngt_set_property_object_type_float(NGTProperty, NGTError);
extern void ngt_destroy_property(NGTProperty);
extern bool ngt_get_property(NGTIndex, NGTProperty, NGTError);
extern int32_t ngt_get_property_dimension(NGTProperty, NGTError);
extern int16_t ngt_get_property_edge_size_for_creation(NGTProperty, NGTError);
extern int16_t ngt_get_property_edge_size_for_search(NGTProperty, NGTError);
extern int32_t ngt_get_property_object_type(NGTProperty, NGTError);
extern int32_t ngt_get_property_distance_type(NGTProperty, NGTError);
extern bool ngt_is_property_object_type_float(int32_t);
extern bool ngt_is_property_object_type_integer(int32_t);
extern NGTIndex ngt_create_graph_and_tree(const char *, NGTProperty, NGTError);
extern NGTIndex ngt_create_graph_and_tree_in_memory(NGTProperty, NGTError);
extern NGTIndex ngt_open_index(const char *, NGTError);
extern void ngt_close_index(NGTIndex);
extern ObjectID ngt_insert_index(NGTIndex, double *, uint32_t, NGTError);
extern ObjectID ngt_append_index(NGTIndex, double *, uint32_t, NGTError);
extern ObjectID ngt_insert_index_as_float(NGTIndex, float *, uint32_t, NGTError);
extern ObjectID ngt_append_index_as_float(NGTIndex, float *, uint32_t, NGTError);
extern bool ngt_batch_append_index(NGTIndex, float *, uint32_t, NGTError);
extern bool ngt_batch_insert_index(NGTIndex, float *, uint32_t, uint32_t *, NGTError);
extern bool ngt_create_index(NGTIndex, uint32_t, NGTError);
extern bool ngt_remove_index(NGTIndex, ObjectID, NGTError);
extern bool ngt_save_index(NGTIndex, const char *, NGTError);
extern NGTObjectDistances ngt_create_empty_results(NGTError);
extern void ngt_destroy_results(NGTObjectDistances);
extern int32_t ngt_get_size(NGTObjectDistances, NGTError);
extern uint32_t ngt_get_result_size(NGTObjectDistances, NGTError);
extern NGTObjectDistance ngt_get_result(const NGTObjectDistances, uint32_t, NGTError);
extern bool ngt_search_index(NGTIndex, double *, int32_t, size_t, float, float, NGTObjectDistances, NGTError);
extern bool ngt_search_index_as_float(NGTIndex, float *, int32_t, size_t, float, float, NGTObjectDistances, NGTError);
extern bool ngt_search_index_with_query(NGTIndex, NGTQuery, NGTObjectDistances, NGTError);
extern bool ngt_linear_search_index(NGTIndex, double *, int32_t, size_t, NGTObjectDistances, NGTError);
extern bool ngt_linear_search_index_as_float(NGTIndex, float *, int32_t, size_t, NGTObjectDistances, NGTError);
extern bool ngt_linear_search_index_with_query(NGTIndex, NGTQuery, NGTObjectDistances, NGTError);
extern uint32_t ngt_get_number_of_objects(NGTIndex, NGTError);
extern uint32_t ngt_get_object_repository_size(NGTIndex, NGTError);
extern NGTObjectSpace ngt_get_object_space(NGTIndex, NGTError);
extern float *ngt_get_object_as_float(NGTObjectSpace, ObjectID, NGTError);
extern uint8_t *ngt_get_object_as_integer(NGTObjectSpace, ObjectID, NGTError);
extern bool ngt_get_edges(NGTIndex, ObjectID, NGTObjectDistances, NGTError);
extern bool ngt_refine_anng(NGTIndex, float, float, int, int, size_t, NGTError);
extern NGTOptimizer ngt_create_optimizer(bool, NGTError);
extern bool ngt_optimizer_set(NGTOptimizer, int, int, int, float, float, float, float, double, double, NGTError);
extern bool ngt_optimizer_set_minimum(NGTOptimizer, int, int, int, int, NGTError);
extern bool ngt_optimizer_set_extension(NGTOptimizer, float, float, float, float, double, double, NGTError);
extern bool ngt_optimizer_set_processing_modes(NGTOptimizer, bool, bool, bool, NGTError);
extern bool ngt_optimizer_execute(NGTOptimizer, const char *, const char *, NGTError);
extern bool ngt_optimizer_adjust_search_coefficients(NGTOptimizer, const char *, NGTError);
extern void ngt_destroy_optimizer(NGTOptimizer);
extern NGTAnngEdgeOptimizationParameter ngt_get_anng_edge_optimization_parameter(void);
extern bool ngt_optimize_number_of_edges(const char *, NGTAnngEdgeOptimizationParameter, NGTError);
extern NGTQGIndex ngtqg_open_index(const char *, NGTError);
extern void ngtqg_initialize_quantization_parameters(NGTQGQuantizationParameters *);
extern bool ngtqg_quantize(const char *, NGTQGQuantizationParameters, NGTError);
extern void ngtqg_initialize_query(NGTQGQuery *);
extern bool ngtqg_search_index(NGTQGIndex, NGTQGQuery, NGTObjectDistances, NGTError);
extern void ngtqg_close_index(NGTQGIndex);

#define CHECK(cond, msg) \
  if (!(cond)) { fprintf(stderr, "FAIL: %s: %s\n", msg, ngt_get_error_string(err)); return 1; }
static void row(float *v, int i) { for (int d = 0; d < 8; d++) v[d] = (float)((i * 29 + d * 13) % 89) / 10.0f; }

int main(int argc, char **argv) {
  /* argv: <scratch index dir> <1M index dir> <queries f32 file> <count> <dim> */
  const char *path = argv[1];
  char onng[1024];
  snprintf(onng, sizeof(onng), "%s.onng", path);
  NGTError err = ngt_create_error_object();
  NGTProperty prop = ngt_create_property(err);
  CHECK(ngt_set_property_dimension(prop, 8, err), "dimension");
  CHECK(ngt_set_property_edge_size_for_creation(prop, 8, err), "edges");
  CHECK(ngt_set_property_edge_size_for_search(prop, 16, err), "search edges");
  CHECK(ngt_set_property_distance_type_l2(prop, err), "metric");
  CHECK(ngt_set_property_object_type_float(prop, err), "object type");
  NGTIndex idx = ngt_create_graph_and_tree(path, prop, err);
  CHECK(idx != NULL, "create");
  ngt_destroy_property(prop);
  float v[8];
  double dv[8];
  for (int i = 0; i < 200; i++) {
    row(v, i);
    for (int d = 0; d < 8; d++) dv[d] = (double)v[d];
    ObjectID id = i % 4 == 0 ? ngt_insert_index_as_float(idx, v, 8, err)
                : i % 4 == 1 ? ngt_append_index_as_float(idx, v, 8, err)
                : i % 4 == 2 ? ngt_insert_index(idx, dv, 8, err)
                             : ngt_append_index(idx, dv, 8, err);
    CHECK(id == (ObjectID)(i + 1), "1-based insert id");
  }
  float batch[10 * 8];
  for (int i = 0; i < 10; i++) row(batch + i * 8, 200 + i);
  CHECK(ngt_batch_append_index(idx, batch, 10, err), "batch append");
  uint32_t ids[10];
  for (int i = 0; i < 10; i++) row(batch + i * 8, 210 + i);
  CHECK(ngt_batch_insert_index(idx, batch, 10, ids, err), "batch insert");
  CHECK(ids[0] == 211 && ids[9] == 220, "batch insert ids");
  CHECK(ngt_create_index(idx, 4, err), "build");
  CHECK(ngt_get_number_of_objects(idx, err) == 220, "count");
  CHECK(ngt_get_object_repository_size(idx, err) >= 220, "repository size");
  NGTProperty got = ngt_create_property(err);
  CHECK(ngt_get_property(idx, got, err), "get property");
  CHECK(ngt_get_property_dimension(got, err) == 8, "get dimension");
  CHECK(ngt_get_property_edge_size_for_creation(got, err) == 8, "get creation edges");
  CHECK(ngt_get_property_edge_size_for_search(got, err) == 16, "get search edges");
  int32_t ot = ngt_get_property_object_type(got, err);
  CHECK(ngt_is_property_object_type_float(ot) && !ngt_is_property_object_type_integer(ot), "float");
  CHECK(ngt_get_property_distance_type(got, err) == 1, "L2 is 1");
  ngt_destroy_property(got);

  row(v, 5);
  for (int d = 0; d < 8; d++) dv[d] = (double)v[d];
  NGTObjectDistances res = ngt_create_empty_results(err);
  CHECK(ngt_search_index(idx, dv, 8, 5, 0.1f, 1e30f, res, err), "search double");
  CHECK(ngt_get_result_size(res, err) == 5 && ngt_get_size(res, err) == 5, "result size");
  CHECK(ngt_get_result(res, 0, err).id == 6 && ngt_get_result(res, 0, err).distance < 1e-4, "self");
  CHECK(ngt_search_index_as_float(idx, v, 8, 5, 0.1f, 1e30f, res, err), "search float");
  CHECK(ngt_get_result(res, 0, err).id == 6, "search float id");
  NGTQuery q;
  q.query = v; q.size = 5; q.epsilon = 0.1f; q.accuracy = 0.0f; q.radius = 1e30f; q.edge_size = 0;
  CHECK(ngt_search_index_with_query(idx, q, res, err), "search query");
  CHECK(ngt_get_result(res, 0, err).id == 6, "search query id");
  q.accuracy = 0.95f;
  CHECK(!ngt_search_index_with_query(idx, q, res, err), "accuracy needs a table");
  ngt_clear_error_string(err);
  q.accuracy = 0.0f;
  CHECK(ngt_linear_search_index(idx, dv, 8, 5, res, err), "linear double");
  CHECK(ngt_get_result(res, 0, err).id == 6, "linear double id");
  CHECK(ngt_linear_search_index_as_float(idx, v, 8, 5, res, err), "linear float");
  CHECK(ngt_get_result(res, 0, err).id == 6, "linear float id");
  CHECK(ngt_linear_search_index_with_query(idx, q, res, err), "linear query");
  CHECK(ngt_get_result(res, 0, err).id == 6, "linear query id");
  NGTObjectSpace space = ngt_get_object_space(idx, err);
  CHECK(space != NULL, "object space");
  float *obj = ngt_get_object_as_float(space, 6, err);
  CHECK(obj != NULL, "object as float");
  for (int d = 0; d < 8; d++) CHECK(fabsf(obj[d] - v[d]) < 1e-6, "object round trip");
  uint8_t *iobj = ngt_get_object_as_integer(space, 6, err);
  CHECK(iobj != NULL && iobj[0] == (uint8_t)v[0], "object as integer");
  CHECK(ngt_get_edges(idx, 6, res, err), "edges");
  uint32_t ne = ngt_get_result_size(res, err);
  CHECK(ne >= 1 && ne <= 64, "edge count");
  NGTObjectDistance e0 = ngt_get_result(res, 0, err);
  CHECK(e0.id >= 1 && e0.id <= 220 && e0.id != 6, "edge id");
  CHECK(ngt_refine_anng(idx, 0.1f, -1.0f, 0, -2147483647, 64, err), "refine");
  CHECK(ngt_save_index(idx, path, err), "save");
  CHECK(ngt_remove_index(idx, 6, err), "remove");
  ngt_close_index(idx);
  NGTIndex re = ngt_open_index(path, err);
  CHECK(re != NULL && ngt_get_number_of_objects(re, err) == 220, "reopen");
  ngt_close_index(re);
  prop = ngt_create_property(err);
  CHECK(ngt_set_property_dimension(prop, 8, err), "in-memory dimension");
  NGTIndex mem = ngt_create_graph_and_tree_in_memory(prop, err);
  CHECK(mem != NULL, "in-memory create");
  ngt_destroy_property(prop);
  row(v, 3);
  CHECK(ngt_insert_index_as_float(mem, v, 8, err) == 1, "in-memory insert");
  ngt_close_index(mem);
  NGTOptimizer opt = ngt_create_optimizer(true, err);
  CHECK(opt != NULL, "optimizer");
  CHECK(ngt_optimizer_set(opt, 6, 30, 0, 0.3f, 0.5f, 0.8f, 0.9f, 0.0, 0.0, err), "optimizer set");
  CHECK(ngt_optimizer_set_minimum(opt, 6, 30, 0, 0, err), "optimizer minimum");
  CHECK(ngt_optimizer_set_extension(opt, 0.3f, 0.5f, 0.8f, 0.9f, 0.0, 0.0, err), "optimizer extension");
  CHECK(ngt_optimizer_set_processing_modes(opt, true, false, true, err), "optimizer modes");
  CHECK(ngt_optimizer_execute(opt, path, onng, err), "optimizer execute");
  CHECK(ngt_optimizer_adjust_search_coefficients(opt, onng, err), "optimizer adjust");
  ngt_destroy_optimizer(opt);
  NGTAnngEdgeOptimizationParameter p = ngt_get_anng_edge_optimization_parameter();
  CHECK(p.no_of_queries == 200 && p.max_of_no_of_edges == 100, "edge parameter defaults");
  p.target_accuracy = 0.9f;
  CHECK(ngt_optimize_number_of_edges(path, p, err), "optimize edges");
  CHECK(ngt_open_index("/nonexistent/nowhere", err) == NULL, "bad open");
  CHECK(strlen(ngt_get_error_string(err)) > 0, "error string set");
  ngt_clear_error_string(err);
  CHECK(strlen(ngt_get_error_string(err)) == 0, "error string cleared");
  NGTQGQuantizationParameters qp;
  ngtqg_initialize_quantization_parameters(&qp);
  CHECK(qp.max_number_of_edges == 128, "qg parameter defaults");
  CHECK(ngtqg_quantize(path, qp, err), "quantize");
  NGTQGIndex qg = ngtqg_open_index(path, err);
  CHECK(qg != NULL, "qg open");
  NGTQGQuery qq;
  ngtqg_initialize_query(&qq);
  CHECK(qq.size == 20 && qq.result_expansion == 3.0f, "qg query defaults");
  row(v, 7);
  qq.query = v; qq.size = 5; qq.epsilon = 0.1f;
  CHECK(ngtqg_search_index(qg, qq, res, err), "qg search");
  CHECK(ngt_get_result_size(res, err) == 5 && ngt_get_result(res, 0, err).id == 8, "qg self");
  ngtqg_close_index(qg);
  printf("SMOKE C API OK\n");
  fflush(stdout);

  /* the 1M index: one search call per query, ids printed */
  int count = atoi(argv[4]), dim = atoi(argv[5]);
  float *qs = (float *)malloc(sizeof(float) * (size_t)count * dim);
  FILE *fh = fopen(argv[3], "rb");
  CHECK(fh && fread(qs, sizeof(float), (size_t)count * dim, fh) == (size_t)count * dim, "queries");
  fclose(fh);
  NGTIndex big = ngt_open_index(argv[2], err);
  CHECK(big != NULL, "open the 1M index");
  printf("OBJECTS %u\n", ngt_get_number_of_objects(big, err));
  for (int i = 0; i < count; ++i) {
    CHECK(ngt_search_index_as_float(big, qs + (size_t)i * dim, dim, 10, 0.1f, 1e30f, res, err),
          "1M search");
    printf("Q %d", i);
    for (uint32_t r = 0; r < ngt_get_result_size(res, err); ++r) printf(" %u", ngt_get_result(res, r, err).id);
    printf("\n");
  }
  ngt_close_index(big);
  free(qs);
  ngt_destroy_results(res);
  ngt_destroy_error_object(err);
  printf("SMOKE 1M OK\n");
  return 0;
}
"""


def capi_arm(path: str, queries: np.ndarray, tmp: str, dev) -> None:
    """Phase 26: the C ABI on the card (see the module docstring)."""
    import ngt_tpu_torch
    from ngt_tpu_torch import native

    t0 = time.time()
    so = native.build_capi()
    build_s = time.time() - t0
    src, exe = os.path.join(tmp, "smoke_capi.c"), os.path.join(tmp, "smoke_capi")
    with open(src, "w") as fh:
        fh.write(SMOKE_C)
    subprocess.run(["g++", "-O1", "-o", exe, src, so, *native.python_link()[1],
                    f"-Wl,-rpath,{os.path.dirname(so)}"],
                   check=True, capture_output=True, text=True, timeout=300)
    qfile = os.path.join(tmp, "capi_queries.f32")
    q = np.ascontiguousarray(queries[:N_CAPI_Q], np.float32)
    q.tofile(qfile)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "NGT_TPU_TORCH_DEVICE"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    if dev.type != "cuda":   # a rehearsal on the CPU; on the card the default holds
        env["NGT_TPU_TORCH_DEVICE"] = dev.type
    t0 = time.time()
    proc = subprocess.run([exe, os.path.join(tmp, "capi_idx"), path, qfile, str(len(q)),
                           str(q.shape[1])], capture_output=True, text=True, timeout=900,
                          env=env)
    secs = time.time() - t0
    if proc.returncode != 0 or "SMOKE 1M OK" not in proc.stdout:
        raise AssertionError(f"the C program failed ({proc.returncode}):\n{proc.stdout[-2000:]}"
                             f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    got = [[int(v) for v in ln.split()[2:]] for ln in lines if ln.startswith("Q ")]
    idx = ngt_tpu_torch.open_index(path, zero_based_numbering=False, device=dev)
    ids, dists = idx.batch_search(q, size=10, epsilon=0.1, radius=float(np.float32(1e30)))
    mine = [[int(i) for i, d in zip(r, dr) if i >= 1 and np.isfinite(d)]
            for r, dr in zip(ids, dists)]
    idx.close()
    device = env.get("NGT_TPU_TORCH_DEVICE", "the default, cuda")
    log(f"C ABI: library built in {build_s:.1f} s ({so}); the smoke's C program on {device}: "
        f"{lines[0]}; {lines[1]}; {len(got)} ngt_search_index_as_float "
        f"calls on phase 21's index; the whole program {secs:.1f} s; ids equal to in-process "
        f"Index.search: {got == mine}")
    if got != mine or len(got) != N_CAPI_Q:
        raise AssertionError("the C ABI's ids differ from the in-process search's")


def samples_arm(dev) -> dict:
    """Phase 27: each samples/torch script's main() in-process on the card
    at SAMPLE_ARGS' sizes (the defaults where none is given); returns each
    one's seconds."""
    import importlib.util

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples", "torch")
    secs = {}
    for name, args in SAMPLE_ARGS.items():
        spec = importlib.util.spec_from_file_location(f"ngt_tpu_torch_sample_{name}",
                                                      os.path.join(root, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.time()
        out = io_quiet(mod.main, ["--device", str(dev.type), *args])
        torch.cuda.synchronize()
        secs[name] = time.time() - t0
        log(f"samples: {name} {' '.join(args) or '(its defaults)'}: {secs[name]:.1f} s; "
            f"{summary(out)}")
        torch.cuda.empty_cache()
    return secs


def io_quiet(fn, argv):
    """``fn(argv)`` with its printed lines held back (the smoke prints a
    summary of each sample's result instead)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(argv)


def summary(out) -> str:
    """A short text of a sample's return value."""
    if isinstance(out, list) and out and isinstance(out[0], dict):
        return "; ".join(", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in r.items()) for r in out)
    if isinstance(out, dict) and "settings" in out:
        return f"build {out['build_s']:.1f} s; " + summary(out["settings"])
    return str(out)[:200]


def traverse_inputs(dev, sp: dict, seed: int, n: int = TRAVERSE_ROWS):
    """``graph_search``'s arguments for one TRAVERSE_SHAPES entry: a
    clustered corpus of ``n`` rows and its 64-NN graph made on the
    card (1% of the rows invalid, some rows padded with -1 or repeating an
    id), its sq8 codes (int8 at one scale, or the uint8 values themselves)
    and the blocks of the first eb columns, queries near corpus rows in the
    codes' units, and seeds: the first five queries have none (done at the
    start)."""
    from ngt_tpu_torch.properties import DistanceType

    g = torch.Generator(device=dev).manual_seed(seed)
    d, m, b = sp["d"], 128, sp["b"]

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g, device=dev)

    x = torch.zeros((n, m), device=dev)
    x[:, :d] = normal(200, d)[ints(200, n)] + 0.5 * normal(n, d)
    if sp["u8"]:
        x[:, :d] = (40 * x[:, :d] + 128).round().clamp(0, 255)
    nbr = torch.empty((n, 64), dtype=torch.int32, device=dev)
    for lo in range(0, n, 4096):
        dd = torch.cdist(x[lo : lo + 4096], x)
        own = torch.arange(dd.shape[0], device=dev)
        dd[own, own + lo] = float("inf")
        nbr[lo : lo + 4096] = dd.topk(64, largest=False).indices.to(torch.int32)
    rows = torch.randperm(n, generator=g, device=dev)[: n // 20]
    nbr[rows[: n // 40], 40:] = -1
    nbr[rows[n // 40 :], 3] = nbr[rows[n // 40 :], 2]
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid[torch.randperm(n, generator=g, device=dev)[: n // 100]] = False
    if sp["u8"]:
        codes, scale = x.to(torch.uint8), 1.0
    else:
        scale = float(x.abs().max()) / 127.0
        codes = (x * (1.0 / scale)).round().clamp(-127, 127).to(torch.int8)
    nbr_eb = nbr[:, : sp["eb"]]
    blocks = codes[nbr_eb.to(torch.int64).clamp(0, n - 1)].reshape(n, -1)
    q = x[ints(n, b)] + 0.3 * normal(b, m)
    q[:, d:] = 0.0
    q = (q / scale).contiguous()
    seeds = ints(n, b, 10).to(torch.int32)
    seeds[:5] = -1
    seeds[5:40, 6:] = -1
    seeds[40:60, 1] = seeds[40:60, 0]
    kw = dict(metric=DistanceType.L2, k=sp["k"], k_radius=sp["kr"], epsilon=sp["eps"],
              width=sp["w"], edge_size=sp["e"], hash_bits=sp["bits"],
              exact_hash=sp["exact"], block_mode=True, seed_x=codes)
    return (blocks, nbr_eb, valid, q, seeds), kw


def traverse_arm(dev, kind: str, reps: int = 5) -> dict:
    """Phase 4's traversal kernel at each TRAVERSE_SHAPES entry: the kernel
    route against the captured ``_step`` loop on the same inputs (raises on
    disagreement), and the median time of the traversal (``_run``: the
    seed pool's copy, the steps, the outputs and the steps' read back,
    closed by a synchronize) on each route over ``reps`` calls after a warm
    one, beside the bound of the live query-steps.  Returns {shape: dict}."""
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph import search as TS
    from ngt_tpu_torch.ops import _build
    from ngt_tpu_torch.ops import traverse as TV

    lib = _build.load()
    for sp in TRAVERSE_SHAPES.values():
        want = TV.smem_bytes(sp["w"], sp["e"], 128)
        if lib.ngt_traverse_smem(sp["w"], sp["e"], 128) != want:
            raise AssertionError("ops/traverse.py::smem_bytes is not the kernel's layout")
    orig_route, orig_run = TS._kernel_route, TS._run
    secs: list = []

    def timed_run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_run(*a, **k)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        return res

    def timed(args, kw, kernel: bool):
        """(the first call's result, median ms of the traversal)"""
        secs.clear()
        if not kernel:
            TS._kernel_route = lambda *a, **k: False
        TS._run = timed_run
        try:
            res = [TS.graph_search(*args, **kw) for _ in range(reps + 1)][0]
        finally:
            TS._kernel_route, TS._run = orig_route, orig_run
        return res, 1e3 * float(np.median(secs[1:]))

    os.environ[trace.SEARCH] = "1"
    out = {}
    try:
        for i, (name, sp) in enumerate(TRAVERSE_SHAPES.items()):
            args, kw = traverse_inputs(dev, sp, SEED + 100 + i)
            n0 = TV.traverse.launches
            got, ms = timed(args, kw, True)
            launched = TV.traverse.launches - n0
            want, plain_ms = timed(args, kw, False)
            if launched != reps + 1 or TV.traverse.launches - n0 != reps + 1:
                raise AssertionError(f"traverse [{name}]: {launched} kernel launches in "
                                     f"{reps + 1} kernel-route calls, then the loop launched it")
            same = got.ids == want.ids
            agree = same.float().mean().item()
            close = bool(torch.isclose(got.dists[same], want.dists[same], rtol=1e-5,
                                       atol=0).all())
            rows = same.all(1)
            counts = all(torch.equal(getattr(got, f)[rows], getattr(want, f)[rows])
                         for f in ("visit_count", "dist_count", "own_steps"))
            q_steps = int(want.own_steps.sum())
            e, m = sp["e"], 128
            step_bytes = e * m + 4 * e + 2 * 32 * e
            bytes_ms = 1e3 * q_steps * step_bytes / HBM_BYTES_PER_S
            latency_ms = 1e3 * want.iters * 2 * HBM_ROUND_TRIP_S
            bound_ms = max(bytes_ms, latency_ms)
            bound_by = "bytes" if bytes_ms >= latency_ms else "dependent round trips"
            log(f"traverse vs loop [{name}: {sp['b']} queries, {kw['seed_x'].dtype} blocks, "
                f"e {e} of {sp['eb']}, w {sp['w']}, 2^{sp['bits']} "
                f"{'exact' if sp['exact'] else 'hashed'} bits] on {kind}: ids agree "
                f"{agree:.6f}, distances within rtol 1e-5 {close}, steps {got.iters} vs "
                f"{want.iters}, counts equal on agreeing rows {counts}; {q_steps} query-steps; "
                f"kernel {ms:.3f} ms, loop {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by "
                f"{bound_by} (bytes {bytes_ms:.3f}, round trips {latency_ms:.3f})")
            if agree < 0.999 or not close or got.iters != want.iters or not counts:
                raise AssertionError(f"the traversal kernel disagrees with the step loop ({name})")
            out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             ids_agree=agree, steps=want.iters, query_steps=q_steps,
                             block_dtype=str(kw["seed_x"].dtype).replace("torch.", ""))
            del args, kw, got, want
            torch.cuda.empty_cache()
    finally:
        del os.environ[trace.SEARCH]
        trace.clear()
    return out


def scan_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """The least time (ms) one window-scan call of b queries over n rows of
    width d could take on the card: its 2*b*n*d flop at the bf16 peak or
    its bytes (q, x and ss read once, the [b, n/128] outputs written once)
    at the HBM rate, whichever is larger, and which one it is."""
    flops = 2.0 * b * n * d
    nbytes = b * d * 2 + n * d * 2 + n * 4 + b * (n // 128) * 8
    by_ops = flops / PEAK_BF16 >= nbytes / PEAK_BYTES
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3, ("operations" if by_ops
                                                                else "bytes")


def scan_widths(WS, dev, kind: str) -> dict:
    """Phases 3 and 4 at the kernel's wider plans (SCAN_WIDTHS): at each
    width the kernel against its plain version on 65,536 rows x 1,024
    queries and on a ragged case (100 queries, 37 windows), then timed at
    the main path's shape, 4,096 queries x 2^20 rows, beside its bound, the
    plain version and the library yardstick.  Rows are seeded normal bf16
    values made on the card.  Returns {d: {err, ms, plain_ms, library_ms,
    bound_ms, bound_by}}."""
    out = {}
    gen = torch.Generator(device=dev)
    for d in SCAN_WIDTHS:
        gen.manual_seed(7 + d)
        xs = torch.randn((65536, d), generator=gen, device=dev)
        qs = xs[:1024] + 0.1 * torch.randn((1024, d), generator=gen, device=dev)
        ss = (xs * xs).sum(1)
        err = compare_scan(WS, qs.bfloat16(), xs.bfloat16(), ss, f"65536 x {d}, 1024 queries")
        compare_scan(WS, qs[:100].bfloat16(), xs[: 128 * 37].bfloat16(), ss[: 128 * 37],
                     f"ragged at d={d}: 100 queries, 37 windows")
        del xs, qs, ss
        n = 1 << 20
        x16 = torch.randn((n, d), generator=gen, device=dev).bfloat16()
        sp = (x16.float() ** 2).sum(1)
        q16 = x16[1:4097].contiguous()
        err = max(err, compare_scan(WS, q16, x16, sp, f"main path shape 4096 x {n} x {d}"))
        ms = time_ms(lambda: WS.window_scan(q16, x16, sp))
        plain_ms = time_ms(lambda: WS.window_scan_plain(q16, x16, sp))
        library_ms = time_ms(lambda: library_scan(q16, x16, sp))
        bound_ms, bound_by = scan_bound(q16.shape[0], n, d)
        log(f"window_scan at 4096 x {n} x {d} on {kind}: {ms:.3f} ms "
            f"({2.0 * 4096 * n * d / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} ms by "
            f"{bound_by}, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms")
        out[d] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                      bound_ms=bound_ms, bound_by=bound_by)
        del x16, sp, q16
        torch.cuda.empty_cache()
    return out


def edge_agreement(idx, data: np.ndarray, what: str, n_rows: int = 2000) -> float:
    """Share of the first edge_size_for_creation edges of ``n_rows`` sampled
    rows (``default_rng(2)``) that are exact k-NN edges (the card's linear
    search); raises below 0.99."""
    k = idx.prop.edge_size_for_creation
    qsel = np.random.default_rng(2).choice(len(data), n_rows, replace=False)
    gt_q, _ = idx.batch_linear_search(data[qsel].astype(np.float32), size=k + 1)
    rows = idx.graph.nbr_ids[qsel + 1, :k] - 1
    agree = float(np.mean([
        len(set(r.tolist()) & set(g[g != s].tolist()[:k])) / k
        for r, g, s in zip(rows, gt_q, qsel)
    ]))
    log(f"{what}: {agree:.5f} of the first {k} edges of {n_rows} rows are exact k-NN edges")
    if agree < 0.99:
        raise AssertionError(f"{what}: edge agreement {agree:.5f} below 0.99")
    return agree


def bench_base5k() -> np.ndarray:
    """bench.py::load_dataset's synthetic 5,000 x 128 base (bench.py:27-28),
    which it takes where the SIFT file is absent."""
    return np.random.default_rng(0).normal(size=(N_BASE5K, 128)).astype(np.float32) * 20 + 100


def rows_4m(base5k: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """bench.py's 4M corpus as uint8 (bench.py:786-790: the base tiled,
    ``default_rng(4)`` normal noise of scale 12, rounded, clipped to
    0..255) and its queries (bench.py:792-795).  The noise is drawn in
    slabs, which gives the numbers of one draw."""
    g = np.random.default_rng(4)
    data = np.tile(base5k, (TILE_4M, 1))
    slab = 1 << 19
    for s in range(0, len(data), slab):
        e = min(s + slab, len(data))
        data[s:e] += g.normal(scale=NOISE_4M, size=(e - s, data.shape[1])).astype(np.float32)
    np.rint(data, out=data)
    np.clip(data, 0, 255, out=data)
    g2 = np.random.default_rng(5)
    queries = base5k[g2.choice(len(base5k), N_4M_Q, replace=True)] + g2.normal(
        scale=NOISE_4M, size=(N_4M_Q, 128)).astype(np.float32)
    return data.astype(np.uint8), queries


def gist_proxy(n: int, d: int = GIST_DIM, seed: int = SEED) -> np.ndarray:
    """bench.py's gist-960-shaped corpus (bench.py:449-478): its recipe is
    ``sift_proxy``'s at d = 960 (power-law spectrum i^-0.4 under a random
    rotation, Zipf(1.05) sizes of 2,048 clusters, shifted non-negative,
    rows shuffled), so the same seed gives the same rows."""
    return sift_proxy(n, d=d, seed=seed, kc=2048)


def qg_row(idx, queries: np.ndarray, size: int, row: tuple, what: str, kind: str):
    """One (epsilon, ef, result_expansion) row of bench.py's search ladders
    on the index's default route, with the stage timer on; result_expansion
    0 leaves the property.  Returns (ids, seconds, the blocks' eb and
    element count), read under the caller's block budget."""
    from ngt_tpu_torch import trace
    from ngt_tpu_torch.graph.search import graph_search
    from ngt_tpu_torch.quant import qgraph as QG

    eps, ef, rexp = row
    old = idx.prop.result_expansion
    if rexp:
        idx.prop.result_expansion = rexp
    restore = stage_env(NGT_TPU_QG_PROFILE="1")
    QG.last_profile.clear()
    graph_search.steps = 0
    trace.clear()
    try:
        t0 = time.time()
        ids, _ = idx.batch_search(queries, size=size, epsilon=eps, ef=ef)
        secs = time.time() - t0
    finally:
        restore()
        idx.prop.result_expansion = old
    once = sum(QG.last_profile.get(st, 0.0) for st in ("quantize", "blocks"))
    qg = idx._qg
    if qg is None:
        raise AssertionError(f"{what}: the search did not take the qg route")
    blocks, nbr_eb = qg._dev_blocks()
    eb = nbr_eb.shape[1]
    log(f"{what}: epsilon {eps}, ef {ef}, result_expansion {rexp or old}: qg mode {qg.mode}, "
        f"codes {str(qg._dev_codes().dtype)}, eb {eb} of {idx.graph.e_max} (blocks "
        f"{tuple(blocks.shape)} {str(blocks.dtype)}, {blocks.numel()} elements), refine "
        f"{qg._resolve_refine(idx.graph.e_max, eb)}; {len(queries) / secs:.0f} queries/s "
        f"({secs:.2f} s, {graph_search.steps} steps; {len(queries) / max(secs - once, 1e-9):.0f} "
        f"queries/s without the one-time quantize and block gather) on {kind}")
    qg_split(secs, -(-len(queries) // int(os.environ.get("NGT_TPU_QG_CHUNK", "512"))))
    return ids, secs, eb, blocks.numel()


def bench_4m_arm(dev, kind: str) -> int:
    """Phase 28: bench.py's 4M arm, the large-single-chip regime (see the
    module docstring).  Returns the window-scan launches of its build."""
    import ngt_tpu_torch
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import window_scan as WS

    t0 = time.time()
    data, queries = rows_4m(bench_base5k())
    log(f"4M arm: {len(data)} x 128 uint8 rows (bench.py's recipe) and {len(queries)} "
        f"queries in {time.time() - t0:.1f} s")
    # card memory, reckoned before the build at the 2^22-row capacity: the
    # build's f32 rows, the u8 mirror (the codes are that tensor), the
    # adjacency (int32 ids + f32 distances of max(64, 2 x 40) columns, as
    # create sets max_edges) and the search's eb 16 blocks of 128 bytes
    cap, e_max = 1 << 22, max(64, 2 * 40)
    reckon = {"f32 rows": cap * 128 * 4, "u8 mirror": cap * 128,
              "adjacency": cap * e_max * 8, "blocks": cap * 16 * 128}
    log("4M arm: reckoned card memory (GiB): " + ", ".join(
        f"{k} {v / 2**30:.2f}" for k, v in reckon.items())
        + f"; sum {sum(reckon.values()) / 2**30:.2f}")
    torch.cuda.reset_peak_memory_stats()
    restore = stage_env(NGT_TPU_BUILD_PROFILE="1")
    WS.window_scan.launches = 0
    try:
        t0 = time.time()
        idx = ngt_tpu_torch.create(None, dimension=128, edge_size_for_creation=40, device=dev)
        idx.batch_insert(data.astype(np.float32), build=True)
        torch.cuda.synchronize()
        build_s = time.time() - t0
    finally:
        restore()
    launches = WS.window_scan.launches
    want = -(-N_4M // 4096)
    log(f"4M arm: build of {N_4M} x 128 (edge_size_for_creation 40): {build_s:.1f} s "
        f"({N_4M / build_s:.0f} rows/s); capacity {idx.store._x.shape[0]}, e_max "
        f"{idx.graph.e_max}; window_scan launches {launches} ({want} expected); peak card "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("4M arm: build phases (s): " + ", ".join(
        f"{label} {sec:.3f}" for label, sec in TB.last_profile))
    if launches != want:
        raise AssertionError(f"4M build: {launches} window-scan launches, {want} expected")
    edge_agreement(idx, data, "4M arm")
    t0 = time.time()
    gt = ground_truth(idx, queries)
    log(f"4M arm: ground truth (batch_linear_search, size 10): {time.time() - t0:.1f} s")
    del data
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    restore = stage_env(NGT_TPU_QG_BLOCK_GB=BLOCK_GB_4M)
    try:
        found, _, eb, elems = qg_row(idx, queries, 10, ROW_4M, f"4M arm, "
                                        f"NGT_TPU_QG_BLOCK_GB {BLOCK_GB_4M}", kind)
    finally:
        restore()
    rec = BF.recall_at_k(found, gt, 10)
    log(f"4M arm: recall@10 {rec:.4f} at epsilon {ROW_4M[0]}, ef {ROW_4M[1]}, "
        f"result_expansion {ROW_4M[2]} (floor {RECALL_FLOOR_4M}); peak card memory of the "
        f"search {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after it")
    # sq8 blocks of eb 16 at the 2^22-row capacity: 8.6e9 elements, past
    # what int32 offsets can address
    if idx._qg.mode != "sq8" or eb != 16 or elems <= 2**31:
        raise AssertionError(f"4M arm: qg mode {idx._qg.mode}, eb {eb}, {elems} block "
                             "elements; sq8 at eb 16 past 2^31 elements expected")
    if rec < RECALL_FLOOR_4M:
        raise AssertionError(f"4M arm: recall@10 {rec:.4f} below {RECALL_FLOOR_4M}")
    idx.close()
    del idx
    torch.cuda.empty_cache()
    return launches


def gist_arm(dev, kind: str) -> None:
    """Phase 29: bench.py's gist-960 arm (see the module docstring)."""
    import ngt_tpu_torch
    from ngt_tpu_torch.graph import build as TB
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import window_scan as WS

    t0 = time.time()
    data = gist_proxy(N_GIST)
    qi = np.random.default_rng(29).choice(N_GIST, N_GIST_Q, replace=False)
    queries = data[qi]
    log(f"gist-960 arm: gist_proxy {N_GIST} x {GIST_DIM} in {time.time() - t0:.1f} s, "
        f"{N_GIST_Q} corpus rows as queries")
    # the build's scan route, seen where build_bulk calls the bulk k-NN
    routes = []
    bulk = BF.fast_knn_l2_bulk

    def seen(*args, **kwargs):
        routes.append(kwargs.get("scan_impl"))
        return bulk(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    restore = stage_env(NGT_TPU_BUILD_PROFILE="1")
    WS.window_scan.launches = 0
    BF.fast_knn_l2_bulk = seen
    try:
        t0 = time.time()
        idx = ngt_tpu_torch.create(None, dimension=GIST_DIM, edge_size_for_creation=40,
                                   device=dev)
        idx.batch_insert(data, build=True)
        torch.cuda.synchronize()
        build_s = time.time() - t0
    finally:
        BF.fast_knn_l2_bulk = bulk
        restore()
    launches = WS.window_scan.launches
    log(f"gist-960 arm: build of {N_GIST} x {GIST_DIM} (d_pad {idx.store.d_pad}, "
        f"edge_size_for_creation 40): {build_s:.1f} s; scan routes {sorted(set(routes))} in "
        f"{len(routes)} calls; window_scan launches {launches}; peak card memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("gist-960 arm: build phases (s): " + ", ".join(
        f"{label} {sec:.3f}" for label, sec in TB.last_profile))
    if launches != 0 or set(routes) != {"blocked"}:
        raise AssertionError(f"gist-960 build: routes {routes}, {launches} launches; the "
                             "blocked route and no window-scan launch expected")
    edge_agreement(idx, data, "gist-960 arm")
    t0 = time.time()
    gt = strip_self(np.concatenate([
        idx.batch_linear_search(queries[i : i + 1024], size=11)[0]
        for i in range(0, N_GIST_Q, 1024)
    ]), qi)
    log(f"gist-960 arm: ground truth (batch_linear_search, size 11, self stripped): "
        f"{time.time() - t0:.1f} s")
    del data
    torch.cuda.empty_cache()
    recs = []
    restore = stage_env(NGT_TPU_QG_BLOCK_GB=BLOCK_GB_GIST)
    try:
        for row in ROWS_GIST:
            torch.cuda.reset_peak_memory_stats()
            found, _, eb, _ = qg_row(idx, queries, 11, row, f"gist-960 arm, "
                                     f"NGT_TPU_QG_BLOCK_GB {BLOCK_GB_GIST}", kind)
            if idx._qg.mode != "sq8" or eb != 17:
                raise AssertionError(f"gist-960 arm: qg mode {idx._qg.mode}, eb {eb}; sq8 "
                                     "at eb 17 expected")
            recs.append(BF.recall_at_k(strip_self(found, qi), gt, 10))
            log(f"gist-960 arm: recall@10 {recs[-1]:.4f}; peak card memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        restore()
    log(f"gist-960 arm: better recall@10 {max(recs):.4f} (floor {GIST_RECALL_FLOOR})")
    if max(recs) < GIST_RECALL_FLOOR:
        raise AssertionError(f"gist-960 arm: recall@10 {max(recs):.4f} below {GIST_RECALL_FLOOR}")
    idx.close()
    del idx
    torch.cuda.empty_cache()


def entries_arm(dev) -> None:
    """Phase 30: the port's entry points on the card: ``entry()`` against
    the same call with device="cpu" (ids on >= 99.9% of entries, distances
    to 1e-4 where the ids agree), then ``dryrun_multichip(8)``, whose 8
    shards share the card."""
    from ngt_tpu_torch import graft_entry as GE

    fn, args = GE.entry()
    if any(a.device.type != dev.type for a in args):
        raise AssertionError("entry() did not put its arguments on the card")
    gi, gd = fn(*args)
    torch.cuda.synchronize()
    fn_c, args_c = GE.entry(device="cpu")
    ci, cd = fn_c(*args_c)
    gi, gd = gi.cpu().numpy(), gd.cpu().numpy()
    same = gi == ci.numpy()
    close = bool(np.allclose(gd[same], cd.numpy()[same], rtol=0, atol=1e-4))
    log(f"entry(): ids {gi.shape} on {dev.type} agree with the CPU on {same.mean():.6f} of "
        f"entries; distances within 1e-4: {close}")
    if same.mean() < 0.999 or not close:
        raise AssertionError("entry() on the card disagrees with the CPU")
    t0 = time.time()
    GE.dryrun_multichip(8)
    torch.cuda.synchronize()
    log(f"dryrun_multichip(8) on {dev.type}: {time.time() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    from ngt_tpu_torch import native
    from ngt_tpu_torch.ops import _build
    from ngt_tpu_torch.ops import bruteforce as BF
    from ngt_tpu_torch.ops import distances as D
    from ngt_tpu_torch.ops import window_scan as WS

    t_start = time.time()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. kernel build, and the host library's (g++), so that no phase
    # below times a first-use compile
    t0 = time.time()
    _build.load()
    log(f"kernel library ready in {time.time() - t0:.1f} s "
        f"(nvcc build {_build.build_info.get('seconds', 0.0):.1f} s)")
    t0 = time.time()
    native.load()
    log(f"host library ready in {time.time() - t0:.1f} s ({native.library_path()})")
    ptxas = _build.build_info.get("ptxas", [])
    for line in ptxas:
        log(f"  ptxas: {line}")
    spills = [ln for ln in ptxas
              if any(int(v) for v in re.findall(r"(\d+) bytes spill", ln))]
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")
    for d in (128, 256, 384, 512):
        smem = ctypes.c_int(0)
        stages = _build.load().ngt_window_scan_plan(d, ctypes.byref(smem))
        log(f"  window_scan plan at d={d}: {stages} ring stages, "
            f"{smem.value} bytes of shared memory")

    # 3. kernel vs plain, small shapes
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((65536, DIM)).astype(np.float32)).to(dev)
    qs = xs[:1024] + 0.1 * torch.from_numpy(
        rng.standard_normal((1024, DIM)).astype(np.float32)).to(dev)
    ss = (xs * xs).sum(1)
    compare_scan(WS, qs.bfloat16(), xs.bfloat16(), ss, "65536 x 128, 1024 queries")
    compare_scan(WS, qs[:100].bfloat16(), xs[:128 * 37].bfloat16(), ss[:128 * 37],
                 "ragged: 100 queries, 37 windows")
    ss[:128] = float(WS.BIG)
    ss[130] = float(WS.BIG)
    wd, wi = WS.window_scan(qs.bfloat16(), xs.bfloat16(), ss)
    if not (bool((wd[:, 0] >= float(WS.BIG) * 0.5).all()) and bool((wi[:, 1] != 130).all())):
        raise AssertionError("masked rows leaked into the window scan")
    compare_scan(WS, qs.bfloat16(), xs.bfloat16(), ss, "masked window + row")
    del xs, qs, ss, wd, wi

    # data: 1M base rows + 10k held-out rows of one generator
    t0 = time.time()
    allx, extra = sift_proxy(N_BASE + N_HELD_OUT, extra=N_APPEND + N_INCR,
                             extra_seed=SEED + 1000)
    base, held = allx[:N_BASE], allx[N_BASE:]
    log(f"data: {N_BASE} x {DIM} base + {N_HELD_OUT} held-out rows in {time.time() - t0:.1f} s")

    # 4. kernel at the main path's shape: the store holds 2^20 slots (1-based
    # ids, slot 0 the dummy, the tail invalid), one 4096-query tile
    cap = 1 << 20
    xh = np.zeros((cap, DIM), np.float32)
    xh[1 : N_BASE + 1] = base
    vh = np.zeros(cap, bool)
    vh[1 : N_BASE + 1] = True
    x = torch.from_numpy(xh).to(dev)
    v = torch.from_numpy(vh).to(dev)
    _, x16, sp = BF.center_rows(x, v, D.sq_norms(x))
    sp = torch.where(v, sp, float(WS.BIG))
    q16 = x16[1:4097].contiguous()
    err = compare_scan(WS, q16, x16, sp, f"main path shape 4096 x {cap} x {DIM}")
    ms = time_ms(lambda: WS.window_scan(q16, x16, sp))
    plain_ms = time_ms(lambda: WS.window_scan_plain(q16, x16, sp))
    library_ms = time_ms(lambda: library_scan(q16, x16, sp))
    b, n = q16.shape[0], x16.shape[0]
    bound_ms, bound_by = scan_bound(b, n, DIM)
    log(f"window_scan at 4096 x {cap} x {DIM} on {kind}: {ms:.3f} ms "
        f"({2.0 * b * n * DIM / ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.3f} ms by "
        f"{bound_by}, plain {plain_ms:.3f} ms, library {library_ms:.3f} ms")
    log("window_scan back to back: " + clocks_under(lambda: WS.window_scan(q16, x16, sp)))
    del x, v, x16, sp, q16
    torch.cuda.empty_cache()
    # 3-4 at the wider plans
    widths = {DIM: dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms, bound_by=bound_by)}
    widths.update(scan_widths(WS, dev, kind))
    trav = traverse_arm(dev, kind)
    torch.cuda.empty_cache()

    launches, append_launches, live_s = drive(base, held, extra, dev, kind, ms)
    torch.cuda.empty_cache()
    u = u8_rows(allx)
    u8_launches = u8_arm(u, dev, kind)
    log(f"window_scan launches: {launches} on the main path's build, {append_launches} on "
        f"its bulk append, {u8_launches} in the u8 arm")
    del allx, base, held, extra
    torch.cuda.empty_cache()
    card_vs_cpu(dev)
    torch.cuda.empty_cache()
    cos_launches = cosine_arm(dev, kind)
    log(f"window_scan launches on the Cosine arm: {cos_launches}")
    torch.cuda.empty_cache()
    metrics_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    mut_s = mutations_card_vs_cpu(dev)
    log(f"live-index checks (phases 14 + 15): {live_s + mut_s:.1f} s")
    torch.cuda.empty_cache()
    quant_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    onng_card_vs_cpu(dev, n=N_ONNG_CHECK)
    torch.cuda.empty_cache()

    # 21-23. the CLI, export and import, and dedup at 1M
    tmp = tempfile.mkdtemp(prefix="ngt_tpu_torch_cli_")
    try:
        cli_launches, path = cli_arm(u, tmp, dev, kind)
        torch.cuda.empty_cache()
        export_import(path, u[N_BASE : N_BASE + N_CLI_Q], tmp, dev, kind)
        torch.cuda.empty_cache()
        dedup_launches = dedup_arm(path, u, dev, kind)
        log(f"window_scan launches: {cli_launches} in the CLI's create, {dedup_launches} in "
            "the dedup's bulk append")
        torch.cuda.empty_cache()
        # 24-27. sharding, the C ABI and the samples
        t0 = time.time()
        sharded_launches = sharded_arm(tmp, dev)
        log(f"phase 24 (sharded, two 1M-row shards): {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.time()
        sharded_card_vs_cpu(dev)
        log(f"phase 25 (sharded card vs CPU): {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.time()
        capi_arm(path, u[N_BASE:], tmp, dev)
        log(f"phase 26 (the C ABI): {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.time()
        sample_s = samples_arm(dev)
        log(f"phase 27 (the samples): {time.time() - t0:.1f} s; " + ", ".join(
            f"{k} {v:.1f}" for k, v in sample_s.items()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # 28-30. bench.py's 4M and gist-960 arms, the entry points
    t0 = time.time()
    launches_4m = bench_4m_arm(dev, kind)
    log(f"phase 28 (the 4M arm): {time.time() - t0:.1f} s")
    t0 = time.time()
    gist_arm(dev, kind)
    log(f"phase 29 (the gist-960 arm): {time.time() - t0:.1f} s")
    t0 = time.time()
    entries_arm(dev)
    log(f"phase 30 (the entry points): {time.time() - t0:.1f} s")

    # 31. kernels, device, result
    # the last three lines go out bare: the kernels line, the nvidia-smi
    # line and the result line are read by machines
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "window_scan",
        "route": "cuda",
        "source": "ngt_tpu_torch/csrc/window_scan.cu",
        "replaces": "ngt_tpu/ops/pallas_scan.py:88",
        "launches": launches + append_launches + cli_launches + dedup_launches
        + sharded_launches + launches_4m,
        "launches_by_path": {"main path: build": launches,
                             "main path: bulk append": append_launches,
                             "u8 arm: build": u8_launches,
                             "Cosine arm: build": cos_launches,
                             "ONNG arm: build (phase 12's index)": cos_launches,
                             "CLI: create (phase 21)": cli_launches,
                             "dedup: bulk append (phase 23)": dedup_launches,
                             "sharded: build (phase 24)": sharded_launches,
                             "4M arm: build (phase 28)": launches_4m,
                             "gist-960 arm: build, blocked route (phase 29)": 0},
        "matched": True,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "max_abs_err_by_d": {str(d): w["err"] for d, w in widths.items()},
        "ms_by_d": {str(d): w["ms"] for d, w in widths.items()},
        "plain_ms_by_d": {str(d): w["plain_ms"] for d, w in widths.items()},
        "bound_ms_by_d": {str(d): w["bound_ms"] for d, w in widths.items()},
        "bound_by_d": {str(d): w["bound_by"] for d, w in widths.items()},
        "library_ms_by_d": {str(d): w["library_ms"] for d, w in widths.items()},
    }, {
        "name": "traverse",
        "route": "cuda",
        "source": "ngt_tpu_torch/csrc/traverse.cu",
        "replaces": "none: the JAX package's traversal is the lax.while_loop of "
                    "ngt_tpu/graph/search.py:369, no Pallas kernel",
        "launches": sum(TRAVERSE_LAUNCHES.values()),
        "launches_by_path": TRAVERSE_LAUNCHES,
        "matched": True,
        "ms": trav["sift"]["ms"],
        "plain_ms": trav["sift"]["plain_ms"],
        "bound_ms": trav["sift"]["bound_ms"],
        "bound_by": trav["sift"]["bound_by"],
        "library_ms": None,
        "library": "no library call computes it",
        **{f"{key}_by_shape": {name: t[key] for name, t in trav.items()}
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "ids_agree", "steps",
                       "query_steps", "block_dtype")},
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
