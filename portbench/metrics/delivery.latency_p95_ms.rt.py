"""The 95th percentile over every (listener, block) audio delivery of the
window's blocks of the callback's time minus the block's due time (when
its last sample left the receiver), in ms, on the host's clock.  A
per-layer metric and not an end-to-end one: between runs on one card it
spreads wider than any bound the benchmark may set (PERF.md §2).  None
where no delivery was due."""

from pbench import e2e


def read(run):
    if not run.latencies:
        return None
    return 1e3 * e2e.p95(run.latencies)
