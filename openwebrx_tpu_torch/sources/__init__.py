"""SDR source layer: device lifecycle, IQ ingest, device registry.

Behavioral port of the reference's L2 (reference ``owrx/source/__init__.py``
state machine + 28 device backends, SURVEY §2.4), redesigned for the block
runtime: a source produces fixed-size complex64 IQ blocks into a pull
queue the DeviceRuntime drains; drivers remain external processes serving
IQ over TCP with a prop:value control socket (the owrx_connector protocol,
reference ``owrx/source/connector.py:18-78``) — or files/test generators
for replay.
"""

from openwebrx_tpu_torch.sources.base import (
    SdrSource, SdrSourceState, SdrBusyState, SdrClientClass,
    SdrSourceEventClient,
)
from openwebrx_tpu_torch.sources.file import FileSource
from openwebrx_tpu_torch.sources.connector import ConnectorSource

__all__ = [
    "SdrSource", "SdrSourceState", "SdrBusyState", "SdrClientClass",
    "SdrSourceEventClient", "FileSource", "ConnectorSource",
]
