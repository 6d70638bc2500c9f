"""Paged KV pool and its block tables (port of `repro.memmgr`)."""
