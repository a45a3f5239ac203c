"""The program's own ``deliver`` spans (inside ``_complete_block``, after
the wait on the block's event: numpy, ADPCM framing, the waterfall's and
the listeners' callbacks), read from the runtime's span log over the
window: total ÷ blocks.  The benchmark's stamps of the same block's
``_complete_block`` hold it."""

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.deliver")
    dispatch, complete = run.spans.get("dispatch"), run.spans.get("complete")
    if log is None or not dispatch or not complete or not run.blocks:
        return None
    got = log.durations(min(a for a, _ in dispatch), max(b for _, b in complete))
    return None if got is None else 1e3 * float(got.sum()) / run.blocks
