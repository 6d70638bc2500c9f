"""The multi-tenant serving stack (port of `repro.serving`): the engine,
its placement policies, the simulator-backed contention oracle, trace
streams and metrics."""
