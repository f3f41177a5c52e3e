"""95th percentile (nearest rank) of the latency over every request of
the window, from the time it was sent to its answer; an unanswered or
failed request counts as infinitely late. The tail of the one-client
cells, read per layer: from run to run on one card it spreads by more
than half of the largest bound an end-to-end metric may have."""

from benchmark.harness.stats import percentile


def read(ctx):
    return percentile(ctx.latencies_ms, 95) if ctx.latencies_ms else None
