"""The runners of the cells, one per traffic ``mode``: a module here has
``run(cell) -> harness.Outcome``."""
