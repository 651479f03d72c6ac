"""Seal cells: volumes from a seeded pool sealed by ONE call of the port's
``pipeline/batch.encode_packed``.

Set-up makes ``pool_volumes`` payloads of the configuration's
``volume_bytes`` on the device from ``--seed`` (one ``torch.Generator``,
one call) and copies them to pageable host memory, then warms up with
the cell's own traffic: the same call over ``warmup_volumes`` volumes.
The window is one ``encode_packed`` call over a source that cycles the
pool and stops yielding volumes once ``--seconds`` have passed; it ends
when the call returns, every volume's parity landed on the host. The
sink keeps nothing but copies of the sampled rows: ``check_share`` of the
rows, ``tail_share`` of the rows that hold zero padding, drawn from the
seed. Once the window has closed, every shard of each sampled row, data
and parity, is compared with the plain reference (reference.py), and the
bytes the sink received with the bytes the volumes fed must produce:
``bytes_wrong`` counts both, and a run that sampled no row is not
correct either.
"""

from __future__ import annotations

import time

import numpy as np

from .. import reference, trace, yardstick
from ..harness import Cell, Check, Outcome


def payloads(device, seed: int, count: int, nbytes: int) -> list:
    """``count`` payloads of ``nbytes`` made on ``device`` from ``seed``
    in one call, as views of one pageable host buffer."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = torch.empty(count * nbytes, dtype=torch.uint8, device=device)
    t.random_(generator=gen)
    host = t.cpu().numpy()
    del t
    return [host[i * nbytes:(i + 1) * nbytes] for i in range(count)]


def volumes(pool: list, n=None, deadline=None, fed=None):
    """The source: (i, pool[i % len(pool)]) for i = 0, 1, ... until ``n``
    volumes or, checked before each, the host clock passes ``deadline``;
    ``fed[0]`` counts the volumes handed out."""
    i = 0
    while (n is None or i < n) and \
            (deadline is None or time.perf_counter() < deadline):
        if fed is not None:
            fed[0] = i + 1
        yield i, pool[i % len(pool)]
        i += 1


class Sink:
    """``encode_packed``'s sink: counts the bytes it receives and copies
    the sampled rows' pieces, keyed (volume, row) -> shard -> [(column,
    bytes)]. ``span`` (a traced window's) wraps each call; None, nothing
    does."""

    def __init__(self, layout: reference.Layout, k: int, seed: int,
                 share: float, tail_share: float, span):
        self.layout, self.k, self.seed = layout, k, seed
        self.share, self.tail_share, self.span = share, tail_share, span
        self.data_bytes = self.parity_bytes = 0
        self.kept: dict = {}

    def sampled(self, key: int, row: int) -> bool:
        share = self.tail_share if self.layout.padded(row) else self.share
        return yardstick.unit_hash(self.seed, key, row) < share

    def __call__(self, key, shard_id, offset, blocks):
        if self.span is None:
            self._take(key, shard_id, offset, blocks)
            return
        with self.span("pb.seal.sink"):
            self._take(key, shard_id, offset, blocks)

    def _take(self, key, shard_id, offset, blocks):
        b = blocks.reshape(1, -1) if blocks.ndim == 1 else blocks
        if shard_id < self.k:
            self.data_bytes += b.size
        else:
            self.parity_bytes += b.size
        row = self.layout.row_of(offset)
        col = offset - self.layout.row_start(row)
        whole = b.shape[1] == self.layout.block(row)
        for j in range(b.shape[0]):
            r = row + j if whole else row
            if self.sampled(key, r):
                self.kept.setdefault((key, r), {}).setdefault(
                    shard_id, []).append((col, np.array(b[j])))


def bytes_wrong(sink: Sink, pool: list, layout: reference.Layout,
                matrix: np.ndarray) -> tuple[int, set]:
    """Bytes of the sampled rows that differ from the reference or never
    arrived, and the volumes they belong to."""
    k = matrix.shape[1]
    wrong, bad = 0, set()
    for (key, row), shards in sink.kept.items():
        data = layout.data(pool[key % len(pool)], row)
        want = np.concatenate([data, reference.apply(matrix[k:], data)])
        block = layout.block(row)
        for s in range(matrix.shape[0]):
            got = np.zeros(block, dtype=np.uint8)
            have = np.zeros(block, dtype=bool)
            for col, piece in shards.get(s, []):
                got[col:col + piece.size] = piece
                have[col:col + piece.size] = True
            n = int(np.count_nonzero((got != want[s]) | ~have))
            if n:
                wrong += n
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
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - cell.t0

    window = trace.Window(cell.trace, cuda)
    sink = Sink(layout, k, cell.seed, tr["check_share"], tr["tail_share"],
                window.span if cell.trace else None)
    st, fed = pipe.PipeStats(), [0]
    launches0 = rs_cuda.apply_gf_matrix_transpose.launches + \
        rs_cuda.apply_gf_matrix_swar.launches
    native0 = rs_native.apply_gf_matrix.calls
    with cell.patch(), trace.gf_calls(cell.trace) as calls, window:
        deadline = time.perf_counter() + cell.seconds
        with window.span("pb.seal.encode_packed"):
            batch.encode_packed(volumes(pool, deadline=deadline, fed=fed),
                                sink, scheme, device=dev, stats=st)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = rs_cuda.apply_gf_matrix_transpose.launches + \
        rs_cuda.apply_gf_matrix_swar.launches - launches0
    native = rs_native.apply_gf_matrix.calls - native0

    matrix = reference.code_matrix(k, k + m)
    wrong, bad = bytes_wrong(sink, pool, layout, matrix)
    missing = abs(fed[0] * layout.shard_size * k - sink.data_bytes) + \
        abs(fed[0] * layout.shard_size * m - sink.parity_bytes)
    checks = [Check("bytes_wrong", wrong + missing, max=0),
              Check("rows_checked", len(sink.kept), min=1)]
    route = "kernels" if not native else "host codec" if not launches \
        else "kernels and host codec"
    info = {"volumes": fed[0], "batches": st.batches, "groups": st.groups,
            "max_group": st.max_group, "launches": launches,
            "host_codec_calls": native, "route": route,
            "rows_checked": len(sink.kept)}
    return Outcome(
        setup_s=setup_s, attempted=fed[0], failed=len(bad), checks=checks,
        readings={"dat_bytes": fed[0] * cfg["volume_bytes"],
                  "seal_seconds": window.seconds, "pipe": st,
                  "sink_bytes": sink.data_bytes + sink.parity_bytes,
                  "launches": launches, "host_codec_calls": native,
                  "gf_bytes": sum(yardstick.gf_call_bytes(*c)
                                  for c in calls),
                  "device_name": torch.cuda.get_device_name(dev)
                  if cuda else "cpu"},
        window=window, memory_peak_bytes=peak, info=info)
