"""The p95 of the program's own ``stage`` spans (inside ``upload``: the
single-threaded copy of each block into pinned memory, which only a card
records), read from the runtime's span log over the window, in ms.  None
where no block of the window was staged."""

import numpy as np

from openwebrx_tpu_torch.core.metrics import Metrics


def read(run):
    log = Metrics.shared().get("device.portbench.span.stage")
    dispatch, complete = run.spans.get("dispatch"), run.spans.get("complete")
    if log is None or not dispatch or not complete:
        return None
    got = log.durations(min(a for a, _ in dispatch), max(b for _, b in complete))
    if got is None or not len(got):
        return None
    return 1e3 * float(np.quantile(got, 0.95, method="higher"))
