"""Process-wide helpers the pipelines share: fault points and the
degraded-read counts."""
