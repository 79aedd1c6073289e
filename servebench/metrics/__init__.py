"""One reader a metric: ``<metric>.py`` defines ``read(run)``, which gives
the metric's number from a ``window.Run``, or None where the run has
nothing for it to read (the harness then leaves the metric out).
Modules whose name starts with ``_`` are shared helpers, not metrics."""
