"""Synthetic token pipeline (port of `repro.data`)."""
