"""The benchmark's entries: how a cell drives the port (``workloads/*.json``'s ``entry``)."""
