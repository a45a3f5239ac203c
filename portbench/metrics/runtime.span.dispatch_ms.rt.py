"""The program's own ``dispatch`` spans (``DeviceRuntime._dispatch_block``:
routing, the upload, every bank's and the waterfall's step, the start of
the block's copies), read from the runtime's span log over the window
(the first dispatch to the last delivery of its blocks): total ÷ blocks.
None where the program keeps no such log, or has overwritten the
window's first records."""

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.dispatch")
    dispatch, deliver = run.spans.get("dispatch"), run.spans.get("deliver")
    if log is None or not dispatch or not deliver or not run.blocks:
        return None
    got = log.durations(min(a for a, _ in dispatch), max(b for _, b in deliver))
    return None if got is None else 1e3 * float(got.sum()) / run.blocks
