"""Host-side runtime observers (the port of ``repro.runtime``, the part the
serving engine uses)."""
