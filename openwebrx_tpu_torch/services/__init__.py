"""Background decoding services: audio chopper, decoder queue, parsers.

Reference: ``owrx/audio/`` (chopper + queue), ``owrx/wsjt.py``,
``owrx/service/`` (SURVEY §2.1).  The heavy demodulation runs on TPU
(service channels come from the channelizer); the batch decoders (jt9,
wsprd, …) remain external binaries driven by a host worker pool exactly
like the reference — this package reproduces the piping and parsing.
"""
