"""Web layer: HTTP server, WebSocket protocol, client connections.

Reference L6 (SURVEY §1: ``owrx/http.py``, ``owrx/websocket.py``,
``owrx/connection.py``, ``owrx/controllers/``) rebuilt on asyncio — one
event loop instead of a thread per connection; DSP results arrive from
DeviceRuntime threads via call_soon_threadsafe.  The wire protocol is the
reference's exactly: ``CLIENT DE SERVER`` handshake, typed JSON
down-messages, binary frame prefixes 0x01 FFT / 0x02 audio / 0x03
secondary FFT / 0x04 HD audio.
"""
