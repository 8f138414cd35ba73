"""The benchmark's general machinery: finding a cell's files by name, the
comparison that decides ``correct``, reading the profiler's trace, and the
result line. Everything particular to a configuration, a traffic mix or a
per-layer metric lives in files of its own (``configs/``, ``traffic/``,
``workloads/``, ``metrics/``)."""
