"""Device milliseconds per part-B request of the merge (`shard.merge` on
the first card: the shards' top-k lists copied there and their top-k)."""

from h100_bench.metrics._shards import per_request_mean
from h100_bench.metrics._trace import total


def read(run):
    sec = total(run, "shard.merge")
    return per_request_mean(run, None if sec is None else sec * 1e3)
