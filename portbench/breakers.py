"""What the control and the fault tests put in the program's place.

Each is a context manager that swaps methods of the port's
``rs_torch.Encoder`` (the host-slab entries the seal and the read paths
call) for the duration of a window, and puts the originals back:

* :func:`control`: the plain reference (reference.py) computing with
  klauspost's Cauchy code matrix: as good a code, whose shards are not
  the ones SeaweedFS writes. It breaks the configurations' first
  guarantee, and ``correct`` has to come out false under it.
* :func:`fault`: the program's own codec with its result broken where it
  is produced: ``unchanged`` hands back its input (a step that returns
  its state unchanged), ``half`` leaves the second half of each batch out
  (zeros), ``altered`` flips one byte of each result.
"""

from __future__ import annotations

import contextlib

import numpy as np

from . import reference

FAULTS = ("unchanged", "half", "altered")
_METHODS = ("encode_parity_host", "encode_parity_host_multi",
            "reconstruct_batch_host")


@contextlib.contextmanager
def _swap(methods: dict):
    from seaweedfs_tpu_torch.ops import rs_torch
    enc = rs_torch.Encoder
    saved = {name: enc.__dict__[name] for name in methods}
    for name, fn in methods.items():
        setattr(enc, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(enc, name, fn)


def control():
    """The reference with the Cauchy matrix in the codec's place."""

    def matrix(enc):
        return reference.cauchy_matrix(enc.data_shards, enc.total_shards)

    def parity(self, batch):
        rows = matrix(self)[self.data_shards:]
        return np.stack([reference.apply(rows, b) for b in np.asarray(batch)])

    def parity_multi(self, batches):
        return [parity(self, b) for b in batches]

    def reconstruct(self, shards, present, wanted=None):
        if wanted is None:
            wanted = sorted(set(range(self.total_shards)) - set(present))
        rows = reference.decode_rows(matrix(self), present, wanted)
        return np.stack([reference.apply(rows, s[:self.data_shards])
                         for s in np.asarray(shards)])

    return _swap({"encode_parity_host": parity,
                  "encode_parity_host_multi": parity_multi,
                  "reconstruct_batch_host": reconstruct})


def fault(kind: str):
    """The program's codec with its results broken by ``kind``."""
    if kind not in FAULTS:
        raise ValueError(f"unknown fault {kind!r}")
    from seaweedfs_tpu_torch.ops import rs_torch
    orig = {name: rs_torch.Encoder.__dict__[name] for name in _METHODS}

    def broken(result, given: np.ndarray) -> np.ndarray:
        y = np.array(np.asarray(result))
        if kind == "unchanged":
            return np.array(given[:, :y.shape[1], :])
        if kind == "half":
            y[y.shape[0] // 2:] = 0
        else:
            y[0, 0, 0] ^= 1
        return y

    def parity(self, batch):
        return broken(orig["encode_parity_host"](self, batch),
                      np.asarray(batch))

    def parity_multi(self, batches):
        return [broken(r, np.asarray(b)) for r, b in
                zip(orig["encode_parity_host_multi"](self, batches), batches)]

    def reconstruct(self, shards, present, wanted=None):
        return broken(orig["reconstruct_batch_host"](self, shards, present,
                                                     wanted),
                      np.asarray(shards))

    return _swap({"encode_parity_host": parity,
                  "encode_parity_host_multi": parity_multi,
                  "reconstruct_batch_host": reconstruct})
