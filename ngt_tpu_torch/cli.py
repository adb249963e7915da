"""Command-line interface of the port (the counterpart of ``ngt_tpu/cli.py``),
mirroring the reference's ``ngt`` / ``ngtqg`` / ``ngtq`` CLIs.

Subcommands, flags, standard output and standard error follow the JAX
package's CLI (bin/ngt/ngt.cpp:77-120 dispatch, parameter parsing
Command.cpp:26-170, Command.h:37-103), including the evaluation text
protocol (``# Query No.=`` / ``# Epsilon=`` / rank-id-distance lines /
``# End of Search``; Command.cpp:333-366) that the evaluator parses, and
the 1-based ids on output.  The ``ngtq-*`` family drives the port's
``IVFPQIndex``, ``quantize`` / ``qsearch`` its ``QuantizedGraphIndex``.

One argument the JAX package does not need: ``--device`` (default
``cuda``), given before the command, is the device every index of the
command runs on:

    python -m ngt_tpu_torch --device cpu search -o e -n 10 index queries.tsv
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

import ngt_tpu_torch
from ngt_tpu_torch import optimizer as O
from ngt_tpu_torch.properties import resolve_distance_type, resolve_object_type


def _load_tsv(path: str, dimension: int) -> np.ndarray:
    """TSV ingestion like ObjectRepository::appendText (reference
    ObjectRepository.h:108-145): parse the first `dimension` columns, ignore
    extras (labels)."""
    from ngt_tpu_torch.native import parse_tsv

    return parse_tsv(path, dimension)


def _epsilon_list(spec: str):
    """'begin[:end[:step[:n]]]' sweep (reference Command.h:76-88)."""
    toks = spec.split(":")
    begin = float(toks[0])
    end = float(toks[1]) if len(toks) >= 2 else begin
    step = float(toks[2]) if len(toks) >= 3 else 0.1
    n = int(toks[3]) if len(toks) >= 4 else 0
    if n > 0:
        return [round(begin + (end - begin) * i / n, 10) for i in range(n + 1)]
    if step <= 0 or end <= begin:
        return [begin]
    count = int((end - begin) / step + 1e-9) + 1
    return [round(begin + i * step, 10) for i in range(count)]


def _expansion_list(spec) -> list:
    """'begin[:end[:[x]step]]' result-expansion sweep (reference
    NGTQCommand.h:321-339: a step prefixed with 'x' multiplies instead of
    adds; default step is additive 1)."""
    toks = str(spec).split(":")
    begin = float(toks[0])
    if len(toks) < 2:
        return [begin]
    end = float(toks[1])
    mul = False
    step = 1.0
    if len(toks) >= 3:
        s = toks[2]
        if s.startswith("x"):
            mul = True
            s = s[1:]
        step = float(s)
    out = []
    v = begin
    while v <= end + 1e-9 and len(out) < 1000:
        out.append(round(v, 10))
        if mul:
            if step <= 1.0 or v <= 0.0:
                # begin=0 would multiply to 0 forever
                break
            v *= step
        else:
            if step <= 0.0:
                break
            v += step
    return out or [begin]


# ------------------------------------------------------------- commands ----


def cmd_create(args):
    from ngt_tpu_torch.properties import GraphType

    gmap = {"a": GraphType.ANNG, "k": GraphType.KNNG,
            "b": GraphType.BKNNG, "i": GraphType.IANNG}
    idx = ngt_tpu_torch.create(
        args.index,
        dimension=args.dimension,
        edge_size_for_creation=args.edge_size_for_creation,
        edge_size_for_search=args.edge_size_for_search,
        distance_type=resolve_distance_type(args.distance_type),
        object_type=resolve_object_type(args.object_type),
        graph_type=gmap.get(getattr(args, "graph_type", "a"), GraphType.ANNG),
        device=args.device,
    )
    if args.data:
        t0 = time.time()
        data = _load_tsv(args.data, args.dimension)
        print(f"Data loading time={time.time() - t0:.6f} (sec)", file=sys.stderr)
        t0 = time.time()
        idx.batch_insert(data, build=not args.no_build)
        print(f"Index creation time={time.time() - t0:.6f} (sec)", file=sys.stderr)
    idx.save()
    return 0


def cmd_append(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    data = _load_tsv(args.data, idx.store.dimension)
    idx.batch_insert(data, build=not args.no_build)
    idx.save()
    return 0


def cmd_build(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    idx.build_index()
    idx.save()
    return 0


def cmd_search(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    queries = _load_tsv(args.query, idx.store.dimension)
    if args.query_size:
        queries = queries[: args.query_size]
    epsilons = _epsilon_list(args.epsilon)
    eval_mode = args.output_mode.startswith("e")
    stream = sys.stdout
    total_time = 0.0
    query_count = 0
    for qi, q in enumerate(queries):
        for eps in epsilons:
            query_count = qi + 1
            t0 = time.time()
            if args.index_type == "s":
                results = idx.linear_search(q, size=args.size)
                stats = {"distance_count": [0], "visit_count": [0]}
            else:
                ids, dists, stats = idx.batch_search(
                    q[None, :],
                    size=args.size,
                    epsilon=eps,
                    radius=args.radius,
                    edge_size=args.edge_size,
                    expected_accuracy=args.accuracy if args.accuracy > 0 else -1.0,
                    with_stats=True,
                    ef=getattr(args, "ef", 0),
                )
                lo = 0 if idx.zero_based else 1
                results = [
                    (int(i), float(d))
                    for i, d in zip(ids[0], dists[0])
                    if i >= lo and np.isfinite(d)
                ]
            dt = time.time() - t0
            total_time += dt
            if eval_mode:
                qrepr = "\t".join(f"{v:g}" for v in q[:3])
                stream.write(f"# Query No.={query_count}\n")
                stream.write(f"# Query={qrepr[:20]} ...\n")
                stream.write(f"# Index Type={args.index_type}\n")
                stream.write(f"# Size={args.size}\n")
                stream.write(f"# Radius={args.radius}\n")
                stream.write(f"# Epsilon={eps:g}\n")
                stream.write(f"# Query Time (msec)={dt * 1000.0:g}\n")
                stream.write(
                    f"# Distance Computation={int(np.sum(stats['distance_count']))}\n"
                )
                stream.write(f"# Visit Count={int(np.sum(stats['visit_count']))}\n")
            else:
                stream.write(f"Query No.{query_count}\n")
                stream.write("Rank\tID\tDistance\n")
            for rank, (oid, dist) in enumerate(results, 1):
                # external ids are zero-based; CLI prints 1-based like the
                # reference's text protocol (Command.cpp:347-350)
                stream.write(f"{rank}\t{oid + 1}\t{dist:g}\n")
            if eval_mode:
                stream.write("# End of Search\n")
            else:
                stream.write(
                    f"Query Time= {dt:g} (sec), {dt * 1000.0:g} (msec)\n"
                )
        if eval_mode:
            stream.write("# End of Query\n")
    if eval_mode:
        stream.write(
            f"# Average Query Time (msec)={total_time * 1000.0 / max(query_count, 1):g}\n"
        )
        stream.write(f"# Number of queries={query_count}\n")
        stream.write("# End of Evaluation\n")
    return 0


def cmd_remove(args):
    """Remove by the CLI's 1-based ids (the ids `search` prints; reference
    Command.cpp remove loop).  The Index object is zero-based, so convert."""
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    if len(args.ids) > 1:
        # one reverse scan + one repair pass for the whole set
        idx.batch_remove([int(oid) - 1 for oid in args.ids])
    else:
        for oid in args.ids:
            idx.remove(int(oid) - 1)
    idx.save()
    return 0


def cmd_export(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    # binary mode: skips str<->bytes conversion of ~2 GB of text at 1M rows
    with open(args.file, "wb") as fh:
        idx.export_index(fh)
    return 0


def cmd_import(args):
    with open(args.file, "rb") as fh:
        ngt_tpu_torch.Index.import_index(fh, path=args.index, device=args.device)
    return 0


def cmd_reconstruct_graph(args):
    from ngt_tpu_torch.properties import GraphType

    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    opt = O.GraphOptimizer(
        out_edges=args.outgoing,
        in_edges=args.incoming,
        adjust_paths=args.mode in ("S", "s"),
        tune_parameters=args.mode != "s",
    )
    opt.execute(idx)
    idx.save(args.out or args.index)
    print(f"graph type={GraphType(idx.prop.graph_type).name}", file=sys.stderr)
    return 0


def cmd_reconstruct_anng(args):
    """Thin an ANNG to a pseudo-ANNG with fewer edges (the reference's
    reconstructANNGFromANNG, GraphReconstructor.h:717-801)."""
    from ngt_tpu_torch.graph.reconstruct import reconstruct_anng_from_anng

    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    n = idx.store.repository_size
    idx.replace_graph(reconstruct_anng_from_anng(idx.graph, n, args.edge_size,
                                                 device=idx.device))
    idx.save(args.out or args.index)
    return 0


def cmd_refine_anng(args):
    from ngt_tpu_torch.graph.reconstruct import refine_anng

    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    refine_anng(idx, epsilon=args.epsilon, num_edges=args.num_edges)
    idx.save()
    return 0


def cmd_prune(args):
    """PANNG pruning (reference Command::prune, Command.cpp:598-695):
    cap out-degree and drop shortcut edges."""
    from ngt_tpu_torch.graph.reconstruct import adjust_paths, reconstruct_graph

    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    n = idx.store.repository_size
    g = reconstruct_graph(
        idx.graph, n, out_edges=args.edge, in_edges=args.path_edge, device=idx.device,
    )
    idx.replace_graph(adjust_paths(g, n, min_edges=args.edge, device=idx.device))
    idx.save()
    return 0


def cmd_optimize_search_parameters(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    O.generate_accuracy_table(idx)
    O.adjust_edge_size(idx)
    idx.save()
    print(f"AccuracyTable={idx.prop.accuracy_table}", file=sys.stderr)
    return 0


def cmd_extract_query(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    q = O.extract_queries(idx, args.n)
    for row in q:
        sys.stdout.write("\t".join(f"{v:g}" for v in row) + "\n")
    return 0


def cmd_eval(args):
    """Compare a ground-truth stream with a result stream
    (reference Optimizer::evaluate, Optimizer.h:130-226)."""
    with open(args.ground_truth) as fh:
        gt = _parse_eval_stream(fh.read())
    with open(args.result) as fh:
        res = _parse_eval_stream(fh.read())
    # the GT stream has its own (single) epsilon level — flatten to {qno: ...}
    gt_q: dict = {}
    for per_eps in gt.values():
        gt_q.update(per_eps)
    print("# epsilon\tprecision\tqueries\tavg-time(ms)")
    for eps in sorted(res.keys()):
        hits = total = 0
        times = []
        for qno, (ids, t) in res[eps].items():
            want = gt_q.get(qno, ([], 0.0))[0]
            if not want:
                continue
            hits += len(set(ids) & set(want))
            total += min(len(want), args.size)
            times.append(t)
        prec = hits / total if total else 0.0
        avg = float(np.mean(times)) if times else 0.0
        print(f"{eps:g}\t{prec:.6f}\t{len(res[eps])}\t{avg:.4f}")
    return 0


def _parse_eval_stream(text: str):
    """Parse the `-o e` search output into {epsilon: {qno: (ids, ms)}}."""
    out: dict = {}
    qno = eps = None
    tms = 0.0
    ids: list[int] = []
    for line in text.splitlines():
        if line.startswith("# Query No.="):
            qno = int(line.split("=")[1])
            ids = []
        elif line.startswith("# Epsilon="):
            eps = float(line.split("=")[1])
        elif line.startswith("# Query Time (msec)="):
            tms = float(line.split("=")[1])
        elif line.startswith("# End of Search"):
            out.setdefault(eps, {})[qno] = (ids, tms)
        elif line and not line.startswith("#"):
            parts = line.split("\t")
            if len(parts) >= 2:
                try:
                    ids.append(int(parts[1]))
                except ValueError:
                    pass
    return out


def cmd_repair(args):
    """Cross-structure consistency repair (reference Command::repair,
    Command.cpp:850-1026): drop dead edges, rebuild missing nodes."""
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    n = idx.store.repository_size
    live = idx.store._valid[:n]
    # remove edges pointing at dead/out-of-range objects
    nbr = idx.graph.nbr_ids[:n]
    dead = (nbr >= n) | ((nbr >= 0) & ~live[np.clip(nbr, 0, n - 1)])
    dead |= nbr == np.arange(n)[:, None]  # self edges
    if dead.any():
        d = idx.graph.nbr_dist[:n]
        d[dead] = np.inf
        nbr[dead] = -1
        order = np.argsort(d, axis=1, kind="stable")
        idx.graph.nbr_dist[:n] = np.take_along_axis(d, order, axis=1)
        idx.graph.nbr_ids[:n] = np.take_along_axis(nbr, order, axis=1)
        idx.graph.degree[:n] = (idx.graph.nbr_ids[:n] >= 0).sum(axis=1)
        print(f"removed {int(dead.sum())} dead edges", file=sys.stderr)
    # tombstone graph nodes without objects
    ghost = idx.graph._has_node[:n] & ~live
    for oid in np.nonzero(ghost)[0]:
        idx.graph.remove_node(int(oid))
    # rebuild graph nodes for objects lacking them
    idx.replace_graph(idx.graph)
    idx.build_index()
    idx.save()
    errs = idx.verify()
    print(f"verify after repair: {errs or 'ok'}", file=sys.stderr)
    return 0 if not errs else 1


def cmd_optimize_number_of_edges(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    out = O.optimize_number_of_edges(
        idx, target_accuracy=args.accuracy, target_size=args.size,
    )
    print(f"sizes={out['sizes']}")
    print(f"edges={out['edges']}")
    print(
        "recommended edge_size_for_creation="
        f"{out['recommended_edge_size_for_creation']}"
    )
    return 0


def cmd_adjust_edge_size(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    e = O.adjust_edge_size(idx, target_accuracy=args.accuracy)
    idx.save()
    print(f"edge_size_for_search={e if e > 0 else 'unlimited'}")
    return 0


def cmd_export_graph(args):
    """Dump adjacency as text: `id: nbr:dist ...` per line (the role of
    `ngt export-graph`, bin/ngt/ngt.cpp:105)."""
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    n = idx.store.repository_size
    for oid in range(1, n):
        if not idx.graph._has_node[oid]:
            continue
        ids, dists = idx.graph.get_node(oid)
        row = "\t".join(f"{int(i)}:{float(d):g}" for i, d in zip(ids, dists))
        sys.stdout.write(f"{oid}\t{row}\n")
    return 0


def cmd_info(args):
    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    if args.mode == "v":
        errs = idx.verify()
        for e in errs:
            print(f"Error: {e}")
        print("The index is valid." if not errs else "The index is invalid.")
        return 0 if not errs else 1
    if args.mode == "c":  # checkGraph: re-derive edges by exact search
        rep = idx.check_graph()
        print(
            f"checked={rep['checked']} mean_overlap={rep['mean_overlap']:.4f}"
            f" min_overlap={rep['min_overlap']:.4f}"
            f" divergent={rep['divergent']}"
        )
        return 0
    n = idx.store.repository_size
    deg = idx.graph.degree[:n][idx.graph._has_node[:n]]
    print(f"# of objects={len(idx)}")
    print(f"dimension={idx.store.dimension}")
    print(f"distance type={idx.prop.distance_type.name}")
    print(f"graph type={idx.prop.graph_type.name}")
    if len(deg):
        print(f"# of nodes={len(deg)}")
        print(f"# of edges={int(deg.sum())}")
        print(f"out-degree min/mean/max={deg.min()}/{deg.mean():.2f}/{deg.max()}")
        if args.mode == "e":  # degree histogram (showStatisticsOfGraph-lite)
            hist = np.bincount(deg)
            for d, c in enumerate(hist):
                if c:
                    print(f"degree {d}: {c}")
    return 0


def cmd_quantize(args):
    from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

    idx = ngt_tpu_torch.open_index(args.index, device=args.device)
    qg = QuantizedGraphIndex.quantize(
        idx, dsub=args.dimension_of_subvector, ksub=16,
        mode=getattr(args, "mode", "auto"),
    )
    qg.save(args.index)
    print(f"quantized mode={qg.mode}")
    return 0


def cmd_qsearch(args):
    from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

    qg = QuantizedGraphIndex.open(args.index, device=args.device)
    queries = _load_tsv(args.query, qg.index.store.dimension)
    epsilons = _epsilon_list(str(args.epsilon))
    expansions = _expansion_list(args.result_expansion)
    sweep = len(epsilons) > 1 or len(expansions) > 1
    for qi, q in enumerate(queries, 1):
        for eps in epsilons:
            for rx in expansions:
                t0 = time.time()
                results = qg.search(
                    q, size=args.size, epsilon=eps, result_expansion=rx,
                )
                dt = time.time() - t0
                print(f"Query No.{qi}")
                if sweep:
                    # the reference's ngtqg search prints the swept knob per
                    # block (NGTQGCommand.cpp epsilon/result-expansion sweep)
                    print(f"# Epsilon={eps:g}")
                    print(f"# Result expansion={rx:g}")
                print("Rank\tID\tDistance")
                for rank, (oid, dist) in enumerate(results, 1):
                    print(f"{rank}\t{oid + 1}\t{dist:g}")
                print(f"Query Time= {dt:g} (sec), {dt * 1000.0:g} (msec)")
    return 0


# --------------------------------------------------------------- ngtq -----
# the reference's separate `ngtq` binary (NGTQ/NGTQCommand.h:574-613:
# create/append/search/remove/info/validate/rebuild/compress) becomes the
# ngtq-* subcommand family; search modes map to the aggregation modes
# (NGTQCommand.h:299-312)


def cmd_ngtq_create(args):
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex(
        args.dimension,
        n_centroids=args.centroids,
        dsub=args.dimension_of_subvector,
        ksub=args.local_centroids,
        metric=resolve_distance_type(args.distance_type),
        raw_store=args.raw_store,
        raw_path=(
            os.path.join(args.index, "raw.f32")
            if args.raw_store == "mmap" else None
        ),
        device=args.device,
    )
    # the raw mmap file lives inside the index dir and batch_insert spills
    # to it immediately — the dir must exist before the first insert
    os.makedirs(args.index, exist_ok=True)
    if args.data:
        t0 = time.time()
        data = _load_tsv(args.data, args.dimension)
        print(f"Data loading time={time.time() - t0:.6f} (sec)",
              file=sys.stderr)
        t0 = time.time()
        ivf.batch_insert(data)
        ivf.build()
        print(f"Index creation time={time.time() - t0:.6f} (sec)",
              file=sys.stderr)
    ivf.save(args.index)
    return 0


def cmd_ngtq_append(args):
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    data = _load_tsv(args.data, ivf.dimension)
    ivf.batch_insert(data)
    if ivf.needs_rebuild():
        print("# index grew past its codebooks; run ngtq-rebuild",
              file=sys.stderr)
    ivf.save(args.index)
    return 0


def cmd_ngtq_search(args):
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    queries = _load_tsv(args.query, ivf.dimension)
    expansions = _expansion_list(args.result_expansion)
    for qi, q in enumerate(queries, 1):
        for rx in expansions:
            t0 = time.time()
            results = ivf.search(
                q, size=args.size, nprobe=args.nprobe,
                result_expansion=rx, mode=args.mode,
            )
            dt = time.time() - t0
            print(f"Query No.{qi}")
            if len(expansions) > 1:
                print(f"# Result expansion={rx:g}")
            print("Rank\tID\tDistance")
            for rank, (oid, dist) in enumerate(results, 1):
                print(f"{rank}\t{oid + 1}\t{dist:g}")
            print(f"Query Time= {dt:g} (sec), {dt * 1000.0:g} (msec)")
    return 0


def cmd_ngtq_info(args):
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    print(f"objects\t{ivf.size}")
    print(f"centroids\t{len(ivf.centroids)}")
    print(f"subvectors\t{ivf.pq.m}")
    print(f"local centroids\t{ivf.pq.ksub}")
    print(f"packed\t{ivf.packed}")
    print(f"needs rebuild\t{ivf.needs_rebuild()}")
    for k, v in ivf.memory_report().items():
        print(f"{k}\t{v}")
    return 0


def cmd_ngtq_validate(args):
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    errs = ivf.verify()
    for e in errs:
        print(f"error: {e}")
    try:
        audit = ivf.quantization_error(sample=args.sample)
        for k, v in audit.items():
            print(f"{k}\t{v:g}")
    except ValueError as exc:
        print(f"# audit skipped: {exc}", file=sys.stderr)
    print("valid" if not errs else "INVALID")
    return 0 if not errs else 1


def cmd_ngtq_rebuild(args):
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    t0 = time.time()
    ivf.rebuild()
    print(f"Rebuild time={time.time() - t0:.6f} (sec)", file=sys.stderr)
    ivf.save(args.index)
    return 0


def cmd_ngtq_remove(args):
    """Tombstone objects by 1-based id (ngtq remove, NGTQCommand.h:430-496)."""
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    ids = [int(v) - 1 for v in args.ids]
    n = ivf.remove(ids, force=args.force)
    for v in args.ids:
        print(f"removed ID={v}", file=sys.stderr)
    print(f"removed\t{n}")
    ivf.save(args.index)
    return 0


def cmd_ngtq_compress(args):
    """Reclaim tombstoned records (NGTQ::Index::compress, Quantizer.h:2747)."""
    from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

    ivf = IVFPQIndex.open(args.index, device=args.device)
    t0 = time.time()
    n = ivf.compress()
    print(f"Compress time={time.time() - t0:.6f} (sec)", file=sys.stderr)
    print(f"reclaimed\t{n}")
    ivf.save(args.index)
    return 0


# ------------------------------------------------------------- dispatch ----


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ngt_tpu_torch",
        description="ANN index on a CUDA device (NGT-compatible command surface)",
    )
    p.add_argument("--device", default="cuda",
                   help="device the command's indexes run on (cuda, cuda:N or cpu)")
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("create", help="create an index (+ optional data load)")
    c.add_argument("-d", "--dimension", type=int, required=True)
    c.add_argument("-D", "--distance-type", default="L2")
    c.add_argument("-g", "--graph-type", default="a",
                   help="a=ANNG, k=KNNG, b=BKNNG, i=IANNG")
    c.add_argument("-o", "--object-type", default="Float")
    c.add_argument("-E", "--edge-size-for-creation", type=int, default=10)
    c.add_argument("-S", "--edge-size-for-search", type=int, default=40)
    c.add_argument("--no-build", action="store_true")
    c.add_argument("index")
    c.add_argument("data", nargs="?")
    c.set_defaults(fn=cmd_create)

    a = sub.add_parser("append", help="append objects from a TSV file")
    a.add_argument("--no-build", action="store_true")
    a.add_argument("index")
    a.add_argument("data")
    a.set_defaults(fn=cmd_append)

    b = sub.add_parser("build", help="index appended objects")
    b.add_argument("index")
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("search", help="search with queries from a TSV file")
    s.add_argument("-n", "--size", type=int, default=20)
    s.add_argument("-e", "--epsilon", default="0.1",
                   help="epsilon or sweep begin:end:step[:n]")
    s.add_argument("-E", "--edge-size", type=int, default=-1)
    s.add_argument("-r", "--radius", type=float, default=float("inf"))
    s.add_argument("-i", "--index-type", choices="tgs", default="t")
    s.add_argument("-o", "--output-mode", default="-")
    s.add_argument("-a", "--accuracy", type=float, default=0.0)
    s.add_argument("--ef", type=int, default=0,
                   help="exploration rank (radius from the ef-th best pool "
                        "entry; rank-based widening, 0 = off)")
    s.add_argument("-Q", "--query-size", type=int, default=0)
    s.add_argument("index")
    s.add_argument("query")
    s.set_defaults(fn=cmd_search)

    r = sub.add_parser("remove", help="remove objects by id")
    r.add_argument("index")
    r.add_argument("ids", nargs="+")
    r.set_defaults(fn=cmd_remove)

    e = sub.add_parser("export", help="export to portable text")
    e.add_argument("index")
    e.add_argument("file")
    e.set_defaults(fn=cmd_export)

    i = sub.add_parser("import", help="import from portable text")
    i.add_argument("index")
    i.add_argument("file")
    i.set_defaults(fn=cmd_import)

    rg = sub.add_parser("reconstruct-graph", help="build an ONNG")
    rg.add_argument("-o", "--outgoing", type=int, default=10)
    rg.add_argument("-i", "--incoming", type=int, default=120)
    rg.add_argument("-m", "--mode", default="S",
                    help="S=shortcut reduction (default), s=skip tuning")
    rg.add_argument("index")
    rg.add_argument("out", nargs="?")
    rg.set_defaults(fn=cmd_reconstruct_graph)

    ra = sub.add_parser("refine-anng", help="re-search & refresh all edges")
    ra.add_argument("-e", "--epsilon", type=float, default=0.1)
    ra.add_argument("-k", "--num-edges", type=int, default=0)
    ra.add_argument("index")
    ra.set_defaults(fn=cmd_refine_anng)

    pr = sub.add_parser("prune", help="PANNG edge pruning")
    pr.add_argument("-e", "--edge", type=int, default=10)
    pr.add_argument("-p", "--path-edge", type=int, default=40)
    pr.add_argument("index")
    pr.set_defaults(fn=cmd_prune)

    osp = sub.add_parser("optimize-search-parameters")
    osp.add_argument("index")
    osp.set_defaults(fn=cmd_optimize_search_parameters)

    xq = sub.add_parser("extract-query", help="synthesize query vectors")
    xq.add_argument("-n", type=int, default=1000)
    xq.add_argument("index")
    xq.set_defaults(fn=cmd_extract_query)

    ev = sub.add_parser("eval", help="precision from two -o e streams")
    ev.add_argument("-n", "--size", type=int, default=20)
    ev.add_argument("ground_truth")
    ev.add_argument("result")
    ev.set_defaults(fn=cmd_eval)

    rp = sub.add_parser("repair", help="fix cross-structure inconsistencies")
    rp.add_argument("index")
    rp.set_defaults(fn=cmd_repair)

    one = sub.add_parser("optimize-number-of-edges",
                         help="extrapolate edge count for a target scale")
    one.add_argument("-a", "--accuracy", type=float, default=0.9)
    one.add_argument("-s", "--size", type=int, default=0)
    one.add_argument("index")
    one.set_defaults(fn=cmd_optimize_number_of_edges)

    aes = sub.add_parser("adjust-edge-size",
                         help="tune edge_size_for_search by measured QPS")
    aes.add_argument("-a", "--accuracy", type=float, default=0.9)
    aes.add_argument("index")
    aes.set_defaults(fn=cmd_adjust_edge_size)

    xg = sub.add_parser("export-graph", help="dump adjacency as text")
    xg.add_argument("index")
    xg.set_defaults(fn=cmd_export_graph)

    inf = sub.add_parser("info")
    inf.add_argument("-m", "--mode", default="-",
                     help="v=verify, e=degree histogram, c=check-graph "
                          "(re-derive edges by exact search, Index.h:886)")
    inf.add_argument("index")
    inf.set_defaults(fn=cmd_info)

    qz = sub.add_parser("quantize", help="build quantized-graph data (NGTQG)")
    qz.add_argument("-Q", "--dimension-of-subvector", type=int, default=2)
    qz.add_argument("-M", "--mode", default="auto",
                    choices=("auto", "sq8", "pq4"),
                    help="block format: auto = by HBM budget (pick_mode)")
    qz.add_argument("index")
    qz.set_defaults(fn=cmd_quantize)

    qs = sub.add_parser("qsearch", help="quantized-graph search")
    qs.add_argument("-n", "--size", type=int, default=20)
    qs.add_argument("-e", "--epsilon", default="0.02",
                    help="epsilon or sweep begin:end:step[:n]")
    qs.add_argument("-p", "--result-expansion", default="3.0",
                    help="expansion or sweep begin:end[:[x]step] "
                         "(x = multiplicative, NGTQCommand.h:321-339)")
    qs.add_argument("index")
    qs.add_argument("query")
    qs.set_defaults(fn=cmd_qsearch)

    # named ngtqg-* aliases mirroring the reference's `ngtqg` binary
    # (NGTQ/NGTQGCommand.cpp:25-293: create/build(=append)/quantize/search)
    qgc = sub.add_parser("ngtqg-create",
                         help="create the ANNG frame for a quantized graph")
    qgc.add_argument("-d", "--dimension", type=int, required=True)
    qgc.add_argument("-D", "--distance-type", default="L2")
    qgc.add_argument("-g", "--graph-type", default="a")
    qgc.add_argument("-o", "--object-type", default="Float")
    qgc.add_argument("-E", "--edge-size-for-creation", type=int, default=40)
    qgc.add_argument("-S", "--edge-size-for-search", type=int, default=0)
    qgc.add_argument("--no-build", action="store_true")
    qgc.add_argument("index")
    qgc.add_argument("data", nargs="?")
    qgc.set_defaults(fn=cmd_create)

    qgb = sub.add_parser("ngtqg-build",
                         help="append objects and index them (ngtqg build)")
    qgb.add_argument("--no-build", action="store_true")
    qgb.add_argument("index")
    qgb.add_argument("data")
    qgb.set_defaults(fn=cmd_append)

    qgq = sub.add_parser("ngtqg-quantize", help="alias of quantize")
    qgq.add_argument("-Q", "--dimension-of-subvector", type=int, default=2)
    qgq.add_argument("-M", "--mode", default="auto",
                     choices=("auto", "sq8", "pq4"))
    qgq.add_argument("index")
    qgq.set_defaults(fn=cmd_quantize)

    qgs = sub.add_parser("ngtqg-search", help="alias of qsearch")
    qgs.add_argument("-n", "--size", type=int, default=20)
    qgs.add_argument("-e", "--epsilon", default="0.02")
    qgs.add_argument("-p", "--result-expansion", default="3.0")
    qgs.add_argument("index")
    qgs.add_argument("query")
    qgs.set_defaults(fn=cmd_qsearch)

    ran = sub.add_parser("reconstruct-anng",
                         help="thin an ANNG to fewer edges "
                              "(reconstructANNGFromANNG)")
    ran.add_argument("-e", "--edge-size", type=int, default=10)
    ran.add_argument("-o", "--out", default="")
    ran.add_argument("index")
    ran.set_defaults(fn=cmd_reconstruct_anng)

    nqc = sub.add_parser("ngtq-create",
                         help="create an NGTQ (IVF+PQ) index")
    nqc.add_argument("-d", "--dimension", type=int, required=True)
    nqc.add_argument("-D", "--distance-type", default="L2")
    nqc.add_argument("-C", "--centroids", type=int, default=256,
                     help="global codebook size")
    nqc.add_argument("-Q", "--dimension-of-subvector", type=int, default=2)
    nqc.add_argument("-c", "--local-centroids", type=int, default=16)
    nqc.add_argument("--raw-store", default="device",
                     choices=("device", "host", "mmap", "none"),
                     help="where raw objects live (mmap = ArrayFile-style "
                          "off-heap file)")
    nqc.add_argument("index")
    nqc.add_argument("data", nargs="?")
    nqc.set_defaults(fn=cmd_ngtq_create)

    nqa = sub.add_parser("ngtq-append",
                         help="incremental insert (no codebook retrain)")
    nqa.add_argument("index")
    nqa.add_argument("data")
    nqa.set_defaults(fn=cmd_ngtq_append)

    nqs = sub.add_parser("ngtq-search", help="IVF+PQ search")
    nqs.add_argument("-n", "--size", type=int, default=20)
    nqs.add_argument("-p", "--nprobe", type=int, default=8)
    nqs.add_argument("-b", "--result-expansion", default="3.0",
                     help="expansion or sweep begin:end[:[x]step] "
                          "(x = multiplicative, NGTQCommand.h:321-339)")
    nqs.add_argument("-m", "--mode", default="refine",
                     help="a/l/c=approx-LUT, r=refine (default), e=exact "
                          "(reference aggregation modes)")
    nqs.add_argument("index")
    nqs.add_argument("query")
    nqs.set_defaults(fn=cmd_ngtq_search)

    nqi = sub.add_parser("ngtq-info", help="NGTQ index info + memory report")
    nqi.add_argument("index")
    nqi.set_defaults(fn=cmd_ngtq_info)

    nqv = sub.add_parser("ngtq-validate",
                         help="consistency + quantization-error audit")
    nqv.add_argument("-s", "--sample", type=int, default=1024)
    nqv.add_argument("index")
    nqv.set_defaults(fn=cmd_ngtq_validate)

    nqr = sub.add_parser("ngtq-rebuild",
                         help="retrain codebooks + re-encode (at capacity)")
    nqr.add_argument("index")
    nqr.set_defaults(fn=cmd_ngtq_rebuild)

    nqd = sub.add_parser("ngtq-remove",
                         help="tombstone objects by 1-based id")
    nqd.add_argument("-f", "--force", action="store_true",
                     help="ignore unknown/already-removed ids")
    nqd.add_argument("index")
    nqd.add_argument("ids", nargs="+")
    nqd.set_defaults(fn=cmd_ngtq_remove)

    nqz = sub.add_parser("ngtq-compress",
                         help="reclaim tombstoned records")
    nqz.add_argument("index")
    nqz.set_defaults(fn=cmd_ngtq_compress)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
