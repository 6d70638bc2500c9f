"""Training: optimizer, train step and loop (port of `repro.train`)."""
