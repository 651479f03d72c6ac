"""Seal cells whose volumes hold large rows: volumes from a seeded pool
sealed by ONE call of the port's ``pipeline/batch.encode_packed``, as in
``seal.py`` (whose ``payloads`` and ``volumes`` make the pool and the
source), with a check that keeps a window of each sampled column chunk.

A large row (10 blocks of 1 GiB) is wider than the batch bound, so the
port column-splits it and the sink receives it chunk by chunk. Keeping
a sampled row whole would keep 14 GiB, so the sink keeps only:

* ``check_share`` of the rows that reach it whole (the small rows, and a
  large row where the bound is past its width), drawn from the seed,
  every shard whole;
* ``chunk_share`` of the column chunks, each over a ``window_bytes``
  window at a column drawn from the seed, every shard;
* every straggler, the narrower last chunk of a split row, whole;

and counts, per volume, the bytes that reach it and the sink call that
opens it (its first byte) and the one that closes it (its last).

Once the window has closed, each check is exact over what it covers:
``bytes_wrong`` compares every kept piece, data and parity, with the
plain reference (reference.py), its data taken from slices of the
volume's source at ``Layout.dat_offset(row) + shard * block + column``
(never a whole large row), and adds, per volume fed, the difference
between the bytes that arrived and 14 shard files' worth;
``rows_checked`` and ``chunks_checked`` are at least 1; and
``volumes_left_open`` counts the volumes i with a volume i + 2 fed whose
bytes had not all arrived before the first byte of volume i + 2 (the
configuration's ``closure``). ``readings`` and ``info`` hold what
``seal.py``'s do, so every ``.seal`` reader reads them, and the run's
split counters (``PipeStats.split_*``, absent from a program without
them), the pieces checked, and the longest a volume stayed open at the
sink on the host clock.
"""

from __future__ import annotations

import math
import resource
import time

import numpy as np

from .. import reference, trace, yardstick
from ..harness import Cell, Check, Outcome
from .seal import payloads, volumes

#: The port's column-split counters (``pipe.PipeStats``), where it has them.
SPLIT_COUNTERS = ("split_rows", "split_chunks", "split_pack_bytes",
                  "split_pack_seconds", "split_hold_max_seconds")


class Sink:
    """``encode_packed``'s sink (module docstring). ``kept`` maps (volume,
    row, first column, width) to {shard: bytes}."""

    def __init__(self, layout: reference.Layout, shards: int, seed: int,
                 traffic: dict):
        self.layout, self.seed = layout, seed
        self.share = traffic["check_share"]
        self.chunk_share = traffic["chunk_share"]
        self.window = traffic["window_bytes"]
        self.whole = shards * layout.shard_size
        self.calls = 0
        self.arrived: dict = {}
        self.opened: dict = {}   # volume -> (call, host clock) of its first
        self.closed: dict = {}   # volume -> (call, host clock) of its last
        self.kept: dict = {}

    def __call__(self, key, shard_id, offset, blocks):
        self.calls += 1
        now = time.perf_counter()
        b = blocks.reshape(1, -1) if blocks.ndim == 1 else blocks
        self.opened.setdefault(key, (self.calls, now))
        self.arrived[key] = self.arrived.get(key, 0) + b.size
        if self.arrived[key] >= self.whole:
            self.closed.setdefault(key, (self.calls, now))
        lay = self.layout
        row = lay.row_of(offset)
        col, width = offset - lay.row_start(row), b.shape[1]
        if width == lay.block(row):
            for j in range(b.shape[0]):
                if yardstick.unit_hash(self.seed, key, row + j) < self.share:
                    self._keep(key, row + j, 0, shard_id, b[j])
            return
        kept = self.window_of(key, row, col, width)
        if kept is not None:
            lo, n = kept
            self._keep(key, row, col + lo, shard_id, b[0, lo:lo + n])

    def window_of(self, key, row: int, col: int, width: int):
        """The columns (first, count) of a column chunk the sink keeps:
        a straggler's all, a sampled chunk's window; None for the rest."""
        if col + width == self.layout.block(row):
            return 0, width
        if yardstick.unit_hash(self.seed, key, row, col) >= self.chunk_share:
            return None
        n = min(self.window, width)
        return int(yardstick.unit_hash(self.seed, key, row, col, 1) *
                   (width - n + 1)), n

    def _keep(self, key, row, start, shard_id, piece):
        # the data views die when the sink returns: copy
        self.kept.setdefault((key, row, start, piece.size), {})[shard_id] = \
            np.array(piece)

    @property
    def rows_checked(self) -> int:
        return sum(n == self.layout.block(row)
                   for _, row, _, n in self.kept)

    @property
    def chunks_checked(self) -> int:
        return len(self.kept) - self.rows_checked

    def volumes_left_open(self, fed: int) -> list:
        """The volumes i < fed - 2 whose last byte did not arrive before
        the first byte of volume i + 2."""
        return [i for i in range(fed - 2)
                if self.closed.get(i, (math.inf,))[0] >=
                self.opened.get(i + 2, (math.inf,))[0]]

    def open_max_seconds(self) -> float:
        """The longest host time from a volume's first byte to its last."""
        return max((t - self.opened[key][1]
                    for key, (_, t) in self.closed.items()), default=0.0)


def source_data(dat: np.ndarray, layout: reference.Layout, row: int,
                start: int, n: int) -> np.ndarray:
    """Columns [start, start + n) of the row's k data blocks, (k, n), from
    slices of the volume's source, zero past its end."""
    block = layout.block(row)
    out = np.zeros((layout.k, n), dtype=np.uint8)
    for s in range(layout.k):
        lo = layout.dat_offset(row) + s * block + start
        piece = dat[lo:min(lo + n, dat.size)]
        out[s, :piece.size] = piece
    return out


def bytes_wrong(sink: Sink, pool: list, layout: reference.Layout,
                matrix: np.ndarray, fed: int) -> tuple[int, set]:
    """Kept bytes that differ from the reference or never arrived, plus
    each fed volume's bytes missing or extra at the sink; and the volumes
    they belong to."""
    k = layout.k
    wrong, bad = 0, set()
    for (key, row, start, n), shards in sink.kept.items():
        data = source_data(pool[key % len(pool)], layout, row, start, n)
        want = np.concatenate([data, reference.apply(matrix[k:], data)])
        for s in range(matrix.shape[0]):
            got = shards.get(s)
            miss = n if got is None else int(np.count_nonzero(got != want[s]))
            if miss:
                wrong += miss
                bad.add(key)
    for key in range(fed):
        miss = abs(sink.arrived.get(key, 0) - sink.whole)
        if miss:
            wrong += miss
            bad.add(key)
    return wrong, bad


def run(cell: Cell) -> Outcome:
    import torch
    from seaweedfs_tpu_torch.ops import rs_cuda, rs_native
    from seaweedfs_tpu_torch.pipeline import batch, pipe
    from seaweedfs_tpu_torch.pipeline.scheme import EcScheme

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sch = cfg["scheme"]
    scheme = EcScheme(sch["data_shards"], sch["parity_shards"],
                      sch["large_block_bytes"], sch["small_block_bytes"])
    k, m = scheme.data_shards, scheme.parity_shards
    cuda = dev.type == "cuda"
    layout = reference.Layout(k, scheme.large_block_size,
                              scheme.small_block_size, cfg["volume_bytes"])
    pool = payloads(dev, cell.seed, tr["pool_volumes"], cfg["volume_bytes"])

    batch.encode_packed(volumes(pool, n=tr["warmup_volumes"]),
                        lambda *_: None, scheme, device=dev)
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - cell.t0

    window = trace.Window(cell.trace, cuda)
    sink = Sink(layout, k + m, cell.seed, tr)
    st, fed = pipe.PipeStats(), [0]
    launches0 = rs_cuda.apply_gf_matrix_transpose.launches + \
        rs_cuda.apply_gf_matrix_swar.launches
    native0 = rs_native.apply_gf_matrix.calls
    with cell.patch(), trace.gf_calls(cell.trace) as calls, window:
        deadline = time.perf_counter() + cell.seconds
        batch.encode_packed(volumes(pool, deadline=deadline, fed=fed),
                            sink, scheme, device=dev, stats=st)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = rs_cuda.apply_gf_matrix_transpose.launches + \
        rs_cuda.apply_gf_matrix_swar.launches - launches0
    native = rs_native.apply_gf_matrix.calls - native0

    matrix = reference.code_matrix(k, k + m)
    wrong, bad = bytes_wrong(sink, pool, layout, matrix, fed[0])
    left_open = sink.volumes_left_open(fed[0])
    checks = [Check("bytes_wrong", wrong, max=0),
              Check("rows_checked", sink.rows_checked, min=1),
              Check("chunks_checked", sink.chunks_checked, min=1),
              Check("volumes_left_open", len(left_open), max=0)]
    route = "kernels" if not native else "host codec" if not launches \
        else "kernels and host codec"
    info = {"volumes": fed[0], "batches": st.batches, "groups": st.groups,
            "max_group": st.max_group, "launches": launches,
            "host_codec_calls": native, "route": route,
            "rows_checked": sink.rows_checked,
            "chunks_checked": sink.chunks_checked,
            "volumes_left_open": len(left_open),
            "volume_open_max_seconds": sink.open_max_seconds(),
            "setup_card_peak_bytes": setup_peak,
            "host_peak_rss_bytes":
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    info.update({name: getattr(st, name, None) for name in SPLIT_COUNTERS})
    return Outcome(
        setup_s=setup_s, attempted=fed[0], failed=len(bad | set(left_open)),
        checks=checks,
        readings={"dat_bytes": fed[0] * cfg["volume_bytes"],
                  "seal_seconds": window.seconds, "pipe": st,
                  "sink_bytes": sum(sink.arrived.values()),
                  "launches": launches, "host_codec_calls": native,
                  "gf_bytes": sum(yardstick.gf_call_bytes(*c)
                                  for c in calls),
                  "device_name": torch.cuda.get_device_name(dev)
                  if cuda else "cpu"},
        window=window, memory_peak_bytes=peak, info=info)
