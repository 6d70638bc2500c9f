"""Roofline analysis (port of `repro.roofline`): HLO parsers, the H100's
roofline terms, and a FLOP and collective counter for torch steps."""
