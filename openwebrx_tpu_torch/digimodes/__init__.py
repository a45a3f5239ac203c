"""Digimode decoders: PSK31/63, RTTY, CW — device DSP + host text decode.

The split (SURVEY §7 step 5): carrier recovery / filtering / timing
recovery run on-device (``models/secondary.py`` chains using
``ops/timing.py``); the final bits→text step (varicode, ITA2, Morse) runs
on host — the symbol rates are tens of baud, so host decode is free, and
it keeps variable-length text out of the static-shape device programs.

Reference analogs: ``pycsdr.modules.DBPskDecoder`` / ``VaricodeDecoder`` /
``RttyDecoder`` / ``BaudotDecoder`` / ``CwDecoder`` (reference
``csdr/chain/digimodes.py:15-180``).
"""
