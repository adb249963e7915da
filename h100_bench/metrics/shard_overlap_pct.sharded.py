"""How much of the fan-out the shards' cards spent working at once: the
shards' `shard<s>.traverse` and `shard<s>.rerank` device seconds summed,
over the shard count times the host span `shard.fanout` (first shard
issued to last shard finished), x 100, part B.  Shards that run one after
another read 100 / shards; all at once near 100."""

from h100_bench.metrics._shards import shards, summed
from h100_bench.metrics._trace import total


def read(run):
    busy = [summed(run, "traverse"), summed(run, "rerank")]
    fan = total(run, "shard.fanout")
    if None in busy or not fan:
        return None
    return 100.0 * sum(busy) / (shards(run) * fan)
