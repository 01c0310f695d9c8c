"""Readers of metrics: ``read(metric, rec)`` returns the metric's value from a
run's record, or None where the run holds nothing to read (the harness then
leaves the metric out of the result line). ``rec`` holds ``spec``, ``images``,
``window_s``, ``setup_s``, ``counters``, ``spans`` (host seconds by span),
``trace`` (trace.summarize, or None) and ``peaks``."""
