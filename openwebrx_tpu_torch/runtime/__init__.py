"""Stage/Chain contract and the streaming banks."""
