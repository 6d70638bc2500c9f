"""The cycle-level memory-system simulator (port of `repro.sim`)."""
