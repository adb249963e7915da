"""Traversal steps per part-B request, summed over the shards (counters
`shard<s>.steps`: each chunk of queries steps until its slowest is done)."""

from h100_bench.metrics._shards import per_request_mean, summed


def read(run):
    return per_request_mean(run, summed(run, "steps"))
