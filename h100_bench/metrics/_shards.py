"""What the readers of the sharded route's spans and counters share
(``ngt_tpu_torch/parallel/sharding.py``: ``shard.fanout``, ``shard.merge``
and per shard s ``shard<s>.traverse``, ``shard<s>.rerank``,
``shard<s>.steps``), read inside part B's requests as ``_trace`` reads.
A program that records none of them reads None."""

from __future__ import annotations

import dataclasses

from h100_bench.metrics._trace import total


def shards(run) -> int:
    return int(run.config.get("shards", 0))


def summed(run, stage: str) -> float | None:
    """``shard<s>.<stage>`` summed over every shard; None where a shard
    recorded none."""
    parts = [total(run, f"shard{s}.{stage}") for s in range(shards(run))]
    return None if not parts or None in parts else sum(parts)


def per_request(run, stage: str) -> list[list[float]] | None:
    """For each part-B request, ``shard<s>.<stage>`` of each shard inside
    it; None where a request lacks a shard's record."""
    out = []
    for req in run.part("B"):
        one = dataclasses.replace(run, requests=[req])
        parts = [total(one, f"shard{s}.{stage}") for s in range(shards(run))]
        if not parts or None in parts:
            return None
        out.append(parts)
    return out or None


def per_request_mean(run, value) -> float | None:
    """``value`` over part B's requests, or None where there is none."""
    n = len(run.part("B"))
    return value / n if n and value is not None else None
