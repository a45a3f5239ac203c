"""The program's own ``control`` spans (each control call on a listener,
its wait for the runtime's lock included), read from the runtime's span
log over the interval of the benchmark's control spans of the changes
due in the window, each of which holds one: total ÷ changes."""

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.control")
    control = run.spans.get("control")
    if log is None or not control or not run.changes:
        return None
    got = log.durations(min(a for a, _ in control), max(b for _, b in control))
    return None if got is None else 1e3 * float(got.sum()) / run.changes
