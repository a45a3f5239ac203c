"""Golden-parity tooling: deterministic IQ captures + a csdr-design oracle.

This package is the recorded-IQ acceptance harness (BASELINE.md: "bit-exact
-within-SNR parity with csdr on recorded IQ captures").  Real captures can't
be committed to the repo, so `capture` generates deterministic, seeded,
realistic multi-signal IQ (stable across platforms — same bytes every run)
and `oracle` implements the reference csdr chain *independently* in
numpy/scipy per-sample semantics using the reference's exact published
design formulas (transition 0.15·out/in, precompensated cutoff,
bandpass transition 320/outRate — /root/reference/csdr/chain/selector.py:21-35,
115-117).  Parity tests (tests/test_parity_golden.py) assert SNR bounds
between the TPU chains and this oracle block-by-block.
"""
