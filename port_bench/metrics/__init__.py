"""One reader per metric, found by the metric's name: ``<family>.py`` for
``<family>`` and for ``<family>.<part>``. ``read(name, ctx)`` returns the
value, or None when the run has nothing to read (the harness then leaves
the metric out of the line). ``ctx`` is ``port_bench.run.Context``."""
