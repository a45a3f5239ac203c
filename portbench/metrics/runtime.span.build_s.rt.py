"""Set-up inside the runtime, from its span log: its ``build``
(``DeviceRuntime.__init__``: the block plan, the waterfall's program),
each ``bank`` it built and ``kernels`` (building or loading the CUDA
kernels), before the window's first dispatch, in seconds."""

from openwebrx_tpu_torch.core.metrics import Metrics

NAMES = ("build", "bank", "kernels")


def read(run):
    logs = [Metrics.shared().get(f"device.portbench.span.{name}") for name in NAMES]
    dispatch = run.spans.get("dispatch")
    if any(log is None for log in logs) or not dispatch:
        return None
    got = [log.durations(float("-inf"), min(a for a, _ in dispatch)) for log in logs]
    return None if any(g is None for g in got) else sum(float(g.sum()) for g in got)
