"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``.

Each defines ``read(rec)`` and returns the metric's value, or None when it
finds nothing to read. ``rec`` holds ``trace`` (the ``TraceRecord`` of the
traced slice), ``traced_units`` and ``untraced_units`` (one entry per step,
or each query's size), ``untraced_s`` (the host seconds of the untraced
units), ``config``, ``traffic`` and ``counts`` (the family's count module)."""
