"""95th percentile of every query's latency, submit to answer read (client clock)."""

from perfbench.readers import p95


def read(rec):
    return p95(rec.latencies_ms)
