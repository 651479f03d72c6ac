"""One reader per metric, ``<metric name>.py`` (loaded by path by
harness.load_metric): ``read(outcome)`` returns the metric's number from
what the run measured, or None where it finds nothing to read, and the
run's line then leaves the metric out."""
