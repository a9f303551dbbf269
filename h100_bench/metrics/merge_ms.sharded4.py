"""Rank 0's device ms a call inside convdr.shard.gather_merge (the all_gather of the shards'
top-k lists and merge_shard_topk) in the traced calls."""

from h100_bench.spans import program_span


def read(obs):
    s = program_span(obs, "convdr.shard.gather_merge", "device_s", "convdr.shard.gather_merge")
    return None if s is None else 1e3 * s
