"""Aggregation's host ms a round (strategy aggregate, compression tiers
included): the History column ``aggregate_host_s`` over the measured
window's rounds."""


def read(ctx):
    rows = ctx["rows"]
    return 1e3 * sum(r.get("aggregate_host_s", 0.0) for r in rows) / len(rows)
