"""The kernel runs that the port's host-slab path makes for a run's
dispatch steps, worked out apart from the port's own counts.

``seaweedfs_tpu_torch.pipeline.pipe.recording_steps`` records, per
dispatch step, the shapes of the batches dispatched together. On the
card, ``rs_torch.apply_matrix_host_multi`` makes one kernel call per
stretch of adjacent slabs of one shape, at most
``SEAWEEDFS_TORCH_DISPATCH_GROUP`` (16) long; a matrix of at most 8
rows is one launch per call. So the launches a run must have made follow
from its steps alone. The ``cuda`` tests and chip_smoke.py hold the
kernels' launch counts to it.
"""

from __future__ import annotations


def expected_runs(steps, cap: int = 16) -> int:
    """Kernel calls over ``steps`` (each a sequence of slab shapes): one
    per maximal stretch of equal shapes inside a step, split every
    ``cap`` slabs."""
    n = 0
    for shapes in steps:
        prev, length = None, 0
        for shape in shapes:
            if shape != prev or length == cap:
                n += 1
                prev, length = shape, 0
            length += 1
    return n


def dispatched(steps) -> list:
    """The shapes of every batch the steps dispatched, in order."""
    return [tuple(s) for shapes in steps for s in shapes]


def plan_shapes(plans) -> list:
    """The batch shapes of ``encode.plan_batches``' plans, in order."""
    return [tuple(p.shape) for p in plans]
