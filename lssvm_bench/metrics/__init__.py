"""One reader per metric, ``<name>.py`` with ``read(ctx) -> float | None``,
found by the metric's name in ``BENCHMARK.json``.  ``ctx`` holds the run:
``window_s``, ``call_s`` (each completed call's host seconds), ``setup_s``,
``points_per_call``, ``learns`` (per learn: iterations, steps executed and,
in a traced run, the program's ``setup`` and ``cg`` span milliseconds),
``trace`` (:class:`lssvm_bench.trace.Trace` in a traced run), ``config``,
``rows``, ``features``, ``chips``.  A reader that finds nothing to read
returns None, and the metric is left out of the line."""
