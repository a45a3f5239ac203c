"""The program's own ``deliver`` spans (inside ``_complete_block``, after
the wait on the block's event: numpy, ADPCM framing, the waterfall's and
the listeners' callbacks), read from the runtime's span log over the
window: total ÷ blocks.  The benchmark's ``deliver`` span of the same
block holds it."""

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.deliver")
    dispatch, deliver = run.spans.get("dispatch"), run.spans.get("deliver")
    if log is None or not dispatch or not deliver or not run.blocks:
        return None
    got = log.durations(min(a for a, _ in dispatch), max(b for _, b in deliver))
    return None if got is None else 1e3 * float(got.sum()) / run.blocks
