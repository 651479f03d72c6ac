"""Process-wide helpers the pipelines and the storage engine share: fault
points, the degraded-read counts and the durability (fsync) barriers."""
