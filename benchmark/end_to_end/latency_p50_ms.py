"""Median latency over every request of the window, from the time it was
due (open loop) or sent (closed loop) to its answer; an unanswered or
failed request counts as infinitely late."""

from benchmark.harness.stats import percentile


def read(ctx):
    return percentile(ctx.latencies_ms, 50) if ctx.latencies_ms else None
