"""PyTorch/CUDA port of seaweedfs_tpu's erasure-coding plane.

A second package beside ``seaweedfs_tpu`` (the JAX reference), with the
same module layout: ``ops/`` (GF(2^8) math, the plain PyTorch codec and
the hand-written CUDA kernels), ``storage/`` (on-disk formats, the
``Volume`` engine and the ``Store`` registry), ``pipeline/``
(``ec.encode`` / ``ec.rebuild`` / ``ec.decode``), ``cluster/`` (master,
volume server, filer server, clients), ``filer/`` and ``cache/`` (the
namespace and the chunk cache it reads through) and ``shell/`` (the
admin shells, ``python -m seaweedfs_tpu_torch shell``). It
imports ``torch`` and never ``jax``, and nothing of ``seaweedfs_tpu``:
the plain numpy modules it needs are copies.

Entry points take ``device=None``, which means ``"cuda"`` and raises if
no GPU is present; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels on the host.
"""
