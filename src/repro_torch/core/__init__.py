"""Policy mechanisms of MASK (port of `repro.core`)."""
