"""One reader a metric, ``<name>.py`` with ``read(run)``: the metric's
value from what the run measured, or None where it has nothing to read."""
