"""shard_host_ms.worlds: host ms a traced step of the program's `shard`
spans (each shard's issue in WorldBatch.step), summed over the shards,
with the ms of each card."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, "worlds.step", "shard")
