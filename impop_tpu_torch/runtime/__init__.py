"""Runtime pieces of the scan: the result journal and stage timers."""
