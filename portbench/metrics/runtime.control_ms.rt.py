"""Span around each control call (``set_offset``, ``open_channel``,
``release_channel``), its wait for the lock included: total ÷ changes."""

from pbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "control", run.changes)
