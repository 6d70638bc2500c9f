"""Fault tolerance (port of `repro.distributed.fault_tolerance`)."""
