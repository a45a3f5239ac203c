"""The program's own ``apply`` spans: each change from its call's return
to the start of the dispatch of the first block whose step runs with it,
read from the runtime's span log over the interval of the benchmark's
control spans of the changes due in the window: total ÷ changes."""

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.apply")
    control = run.spans.get("control")
    if log is None or not control or not run.changes:
        return None
    got = log.durations(min(a for a, _ in control), max(b for _, b in control))
    return None if got is None else 1e3 * float(got.sum()) / run.changes
