"""Set-up inside the block steps (``runtime/chain.py`` ``GraphStep``), from
the runtime's span log: each step's ``eager`` first block at a layout
(lazy cuFFT plans, cuDNN algorithms, kernel modules) and its CUDA graph
``capture``, before the window's first dispatch, in seconds."""

from openwebrx_tpu_torch.core.metrics import Metrics

NAMES = ("eager", "capture")


def read(run):
    logs = [Metrics.shared().get(f"device.portbench.span.{name}") for name in NAMES]
    dispatch = run.spans.get("dispatch")
    if any(log is None for log in logs) or not dispatch:
        return None
    got = [log.durations(float("-inf"), min(a for a, _ in dispatch)) for log in logs]
    return None if any(g is None for g in got) else sum(float(g.sum()) for g in got)
