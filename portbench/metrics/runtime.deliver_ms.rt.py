"""Span of ``DeviceRuntime._complete_block`` after the block's copy
events are done (numpy, ADPCM framing, callbacks): total ÷ blocks."""

from pbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "deliver", run.blocks)
