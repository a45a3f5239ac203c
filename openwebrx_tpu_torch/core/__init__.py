"""Control-plane core: property substrate, config, modes registry.

Host-side Python — the reactive backbone everything hangs off
(reference L1, SURVEY §1: ``owrx/property/``, ``owrx/config/``).
"""
