"""The program's own ``hold`` spans: each block from the end of its
dispatch until the runtime's loop takes it off its queue to complete it
(at real time, the loop's next poll of the source finding nothing newer),
read from the runtime's span log over the window: total ÷ blocks."""

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.hold")
    dispatch, complete = run.spans.get("dispatch"), run.spans.get("complete")
    if log is None or not dispatch or not complete or not run.blocks:
        return None
    got = log.durations(min(a for a, _ in dispatch), max(b for _, b in complete))
    return None if got is None else 1e3 * float(got.sum()) / run.blocks
