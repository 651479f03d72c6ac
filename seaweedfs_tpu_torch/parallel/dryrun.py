"""The dry run of the split: the port's twin of the JAX package's
multi-device dry run (``__graft_entry__._dryrun_body``).

:func:`run` takes a list of devices (CPU entries, or cards; an entry may
repeat), builds the most-square mesh over them and runs three parts,
each held byte for byte against the numpy oracle ``ops/rs_ref``:

A. the full train step — encode, lose shards 0, 5, 11 and 13,
   reconstruct them, compare — with 0 mismatches, and every parity row
   equal to the oracle's;
B. the rebuild of REAL shard files (a volume of needles sealed by
   ``encode_volume``, shards lost) on the mesh from four uneven survivor
   sets;
C. the config-3 batcher: many small volumes coalesced by
   ``pipeline/batch`` into packed row batches and encoded on the mesh.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..ops import rs_ref
from ..pipeline import batch as batch_mod
from ..pipeline import encode as encode_mod
from ..pipeline.scheme import EcScheme
from ..storage import ec_files, needle
from ..storage.volume import Volume
from . import mesh as mesh_mod

LOST = (0, 5, 11, 13)
#: Uneven survivor sets of part B: data-heavy, parity-heavy, minimal
#: mixes, parity first.
REBUILD_CASES = (
    ((13,), list(range(13))),
    ((3, 7), [0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13]),
    ((0, 5, 11, 13), [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]),
    ((1, 2, 3, 4), [0, 10, 11, 12, 13, 5, 6, 7, 8, 9]),
)
#: Small blocks, so a few KiB of needles span several rows.
SCHEME = EcScheme(large_block_size=8192, small_block_size=2048)


class DryRunError(RuntimeError):
    pass


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise DryRunError(what)


def run(devices) -> dict:
    """Run parts A-C on the most-square mesh over ``devices``; raises
    :class:`DryRunError` on any mismatch. Returns what was checked."""
    mesh = mesh_mod.make_mesh(list(devices))
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    device = mesh.devices[0][0]
    enc = SCHEME.encoder(device)
    oracle = rs_ref.ReferenceEncoder(SCHEME.data_shards,
                                     SCHEME.parity_shards)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (dp * 2, 10, 128 * sp * 2), dtype=np.uint8)
    step = mesh_mod.make_sharded_train_step(enc, mesh, lost=LOST)
    parity, mismatches = step(mesh_mod.shard_batch(x, mesh))
    _expect(mismatches == 0,
            f"train step reconstruct mismatches: {mismatches}")
    got = np.asarray(parity)
    for i in range(x.shape[0]):
        _expect(np.array_equal(got[i], oracle.encode_parity(x[i])),
                f"train step parity row {i} differs from rs_ref")
    return {"mesh": dict(mesh.shape), "parity": list(got.shape),
            "mismatches": mismatches,
            "file_rebuild_survivor_sets": _file_rebuild(mesh, device),
            "config3_rows": _config3(mesh, device)}


def _file_rebuild(mesh: mesh_mod.Mesh, device: torch.device) -> int:
    """Part B: seal a real volume into shard FILES, then rebuild the
    bytes of lost shards on the mesh from each uneven survivor set and
    compare them with the files."""
    enc = SCHEME.encoder(device)
    k, total = SCHEME.data_shards, SCHEME.total_shards
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    with tempfile.TemporaryDirectory(prefix="dryrun-ec-") as td:
        base = os.path.join(td, "1")
        rng = np.random.default_rng(7)
        with Volume(base, 1).create() as v:
            for i in range(12):
                v.write_needle(needle.Needle(
                    cookie=1, id=i + 1, append_at_ns=i + 1,
                    data=rng.integers(0, 256, 3000,
                                      dtype=np.uint8).tobytes()))
        encode_mod.encode_volume(base, SCHEME, device=device)
        originals = {i: np.fromfile(ec_files.shard_path(base, i),
                                    dtype=np.uint8) for i in range(total)}
    s = originals[0].size
    gran = sp * mesh_mod.GROUP
    s_pad = -(-s // gran) * gran
    for lost, present in REBUILD_CASES:
        surv = np.zeros((1, k, s_pad), dtype=np.uint8)
        for j, pid in enumerate(present[:k]):
            surv[0, j, :s] = originals[pid]
        surv = np.tile(surv, (dp, 1, 1))  # fill the dp axis
        step = mesh_mod.make_sharded_rebuild_step(enc, mesh, present,
                                                  list(lost))
        rebuilt, csum = step(mesh_mod.shard_batch(surv, mesh))
        got = np.asarray(rebuilt)
        for j, lid in enumerate(lost):
            _expect(np.array_equal(got[0, j, :s], originals[lid]),
                    f"file rebuild mismatch shard {lid} (lost={lost}, "
                    f"present[:k]={present[:k]})")
        _expect(csum == int(got.astype(np.uint64).sum()) % 2 ** 32,
                f"file rebuild checksum {csum} (lost={lost})")
    return len(REBUILD_CASES)


def _config3(mesh: mesh_mod.Mesh, device: torch.device) -> int:
    """Part C: coalesce many small volumes through the config-3 batcher
    and encode the packed batches on the mesh, every real row against
    the oracle."""
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, 3000 + 700 * i, dtype=np.uint8)
                for i in range(6)]
    oracle = rs_ref.ReferenceEncoder(SCHEME.data_shards,
                                     SCHEME.parity_shards)
    step = mesh_mod.make_sharded_encode_step(SCHEME.encoder(device), mesh)
    rows_done = 0
    for _spans, packed in batch_mod.iter_packed_batches(
            ((i, p) for i, p in enumerate(payloads)), SCHEME):
        r, k, block = packed.shape
        _expect(block % (sp * mesh_mod.GROUP) == 0,
                f"config3 block {block} does not split over sp={sp}")
        r_pad = -(-r // dp) * dp
        if r_pad != r:
            packed = np.concatenate(
                [packed, np.zeros((r_pad - r, k, block), np.uint8)])
        parity, _csum = step(mesh_mod.shard_batch(packed, mesh))
        got = np.asarray(parity)
        for i in range(r):
            _expect(np.array_equal(got[i],
                                   oracle.encode_parity(packed[i])),
                    f"config3 row {i} differs from rs_ref")
        rows_done += r
    _expect(rows_done > 0, "config3 packed no rows")
    return rows_done
