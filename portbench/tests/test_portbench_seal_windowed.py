"""The ``seal_windowed`` mode (modes/seal_windowed.py) and the cell that
runs it, ``seal_30000mib_volumes``, at a CPU size of their own: the seal
mode's tiny size (``tiny.TINY["seal"]``) with the configuration's and
the mix's ``"tiny"`` objects merged over it, as ``tiny.overrides`` merges
them for the modes it lists. Each volume is two 655,360 B large rows,
each a 419,328 B column chunk and a 236,032 B straggler at the 4 MiB CPU
bound, then two whole small rows.

The cell keeps the benchmark's rules and runs correct through ``python3
-m portbench``, traced and not; each check catches the fault it is for
(a flipped parity byte in a straggler or in a sampled window, a dropped
straggler, a packer that holds the stragglers to the call's end), and
the control reads incorrect. On the card (``-m cuda``): the cell at its
own size over a short window."""

import contextlib
import json
import time

import pytest

from portbench import breakers, harness, hostspans
from portbench.modes import seal, seal_windowed
from portbench.tests import rules, tiny

CELL = "seal_30000mib_volumes"
MODE = "seal_windowed"
#: Volumes the fault tests' source hands out, whatever the window: the
#: closure check needs a volume i + 2.
FED = 4


def _size(everything: bool = False) -> dict:
    bench = harness.load_benchmark(tiny.ROOT)
    w = harness.workload(bench, CELL)
    mix = harness.load_traffic(w["traffic"])
    out = harness._merge(tiny.TINY["seal"], {
        "config": harness.load_config(bench, w["config"]).get("tiny", {}),
        "traffic": mix.get("tiny", {})})
    if everything:
        out["traffic"].update(chunk_share=1.0)
    return out


@pytest.fixture
def tiny_size(monkeypatch):
    """``tiny.overrides`` (and so ``tiny.run_cli``) give this cell its
    size: the seal mode's, under this mode's name, for the test."""
    monkeypatch.setitem(tiny.TINY, MODE, tiny.TINY["seal"])
    assert tiny.overrides(CELL) == _size()


def _lines(proc) -> tuple[dict, dict]:
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2][len("portbench: "):]), json.loads(lines[-1])


def test_the_cell_keeps_the_rules_and_reports_the_seal_metrics():
    assert rules.problems(tiny.ROOT) == []
    bench = harness.load_benchmark(tiny.ROOT)
    mix = harness.load_traffic(harness.workload(bench, CELL)["traffic"])
    assert mix["mode"] == MODE and CELL not in tiny.CELLS
    seal_layer = {m["name"] for m in harness.cell_metrics(
        bench, "seal_1gib_volumes", True)}
    mine = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert mine == seal_layer | {"split_pack_gibps.seal"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} == \
        {"seal_gibps", "setup_s"}


def test_the_cell_runs_correct_through_the_command(tiny_size):
    bench = harness.load_benchmark(tiny.ROOT)
    info, res = _lines(tiny.run_cli(CELL))
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"seal_gibps", "setup_s"}
    assert set(res["checks"]) == {"bytes_wrong", "rows_checked",
                                  "chunks_checked", "volumes_left_open"}
    assert info["split_rows"] == 2 * info["volumes"] > 0
    assert info["split_chunks"] == 4 * info["volumes"]
    assert info["rows_checked"] >= 1 and info["chunks_checked"] >= 1

    info, res = _lines(tiny.run_cli(CELL, trace=1))
    assert res["correct"] is True, res["checks"]
    names = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert set(res["metrics"]) <= names
    assert res["metrics"]["split_pack_gibps.seal"]["value"] > 0
    assert res["metrics"]["pack_busy.seal"]["value"] > 0


def _fixed_source(monkeypatch):
    """The window's source hands out :data:`FED` volumes, whatever the
    deadline."""
    def source(pool, n=None, deadline=None, fed=None):
        return seal.volumes(pool, n=n if deadline is None else FED, fed=fed)

    monkeypatch.setattr(seal_windowed, "volumes", source)


def _run(seed, patch=None, everything=False):
    with tiny.small_batches():
        return harness.run(CELL, seed, 0.2, False, time.perf_counter(),
                           device="cpu",
                           patch=patch or contextlib.nullcontext,
                           overrides=_size(everything))


def test_a_fixed_source_is_correct_and_closes_every_volume(monkeypatch):
    _fixed_source(monkeypatch)
    result, outcome = _run(2 ** 31 + 41)
    assert result["correct"] is True, result["checks"]
    assert outcome.info["volumes"] == result["attempted"] == FED
    assert result["checks"]["volumes_left_open"]["value"] == 0
    assert outcome.info["volume_open_max_seconds"] > 0
    assert 0 <= outcome.info["split_hold_max_seconds"] < \
        outcome.readings["seal_seconds"]


@contextlib.contextmanager
def _between_program_and_sink(alter):
    """``encode_packed`` with ``alter(sink, key, shard, offset, blocks)``
    between the port and the mode's sink: it calls the sink (or not) with
    what it likes."""
    from seaweedfs_tpu_torch.pipeline import batch
    inner = batch.encode_packed

    def encode_packed(sources, sink, *args, **kw):
        return inner(sources, lambda *a: alter(sink, *a), *args, **kw)

    batch.encode_packed = encode_packed
    try:
        yield
    finally:
        batch.encode_packed = inner


def _straggler(sink, offset, blocks) -> bool:
    lay = sink.layout
    row = lay.row_of(offset)
    return row < lay.large_rows and \
        offset + blocks.shape[-1] == lay.row_start(row) + lay.block(row) \
        and offset > lay.row_start(row)


def _flip_parity_of_stragglers(sink, key, shard, offset, blocks):
    if shard == 10 and _straggler(sink, offset, blocks):
        blocks = blocks.copy()
        blocks[..., 0] ^= 1
    sink(key, shard, offset, blocks)


def _flip_parity_in_sampled_windows(sink, key, shard, offset, blocks):
    lay = sink.layout
    row = lay.row_of(offset)
    width = blocks.shape[-1]
    if shard == 11 and row < lay.large_rows and width < lay.block(row) \
            and not _straggler(sink, offset, blocks):
        # the middle of the window the sink keeps of this chunk
        lo, n = sink.window_of(key, row, offset - lay.row_start(row), width)
        blocks = blocks.copy()
        blocks[..., lo + n // 2] ^= 0x80
    sink(key, shard, offset, blocks)


def _drop_stragglers(sink, key, shard, offset, blocks):
    if not _straggler(sink, offset, blocks):
        sink(key, shard, offset, blocks)


@pytest.mark.parametrize("alter", [_flip_parity_of_stragglers,
                                   _flip_parity_in_sampled_windows],
                         ids=["straggler", "sampled-window"])
def test_a_flipped_parity_byte_is_a_wrong_byte(monkeypatch, alter):
    _fixed_source(monkeypatch)
    result, outcome = _run(2 ** 31 + 42,
                           lambda: _between_program_and_sink(alter),
                           everything=True)
    assert result["correct"] is False
    assert result["checks"]["bytes_wrong"]["value"] >= 1
    assert result["checks"]["volumes_left_open"]["value"] == 0
    assert result["failed"] == FED


def test_a_dropped_straggler_fails_the_volume_count(monkeypatch):
    _fixed_source(monkeypatch)
    result, _ = _run(2 ** 31 + 43,
                     lambda: _between_program_and_sink(_drop_stragglers))
    # 14 shards x 236,032 B of each of the two large rows, per volume
    assert result["checks"]["bytes_wrong"]["value"] == \
        FED * 2 * 14 * 236_032
    assert result["correct"] is False and result["failed"] == FED


#: A batch bound at which a straggler does not fill a batch: 319,872 B
#: chunks and a 15,616 B straggler, 20 of which a bucket would hold.
HELD_BOUND = 3_200_000


@contextlib.contextmanager
def _stragglers_held_to_the_end():
    """The packer as it was: column chunks go to the per-shape buckets
    like rows, so at :data:`HELD_BOUND` every straggler waits in its
    bucket until the call ends."""
    from seaweedfs_tpu_torch.pipeline import batch, pipe
    inner = batch._iter_volume_rows
    cfg = pipe.current()
    saved = (cfg.batch_bytes, cfg.grouped_batch_bytes)

    def rows(*args, **kw):
        for key, part, _chunk in inner(*args, **kw):
            yield key, part, False

    batch._iter_volume_rows = rows
    pipe.configure(batch_bytes=HELD_BOUND, grouped_batch_bytes=HELD_BOUND)
    try:
        yield
    finally:
        batch._iter_volume_rows = inner
        pipe.configure(batch_bytes=saved[0], grouped_batch_bytes=saved[1])


def test_a_packer_that_holds_the_stragglers_leaves_volumes_open(
        monkeypatch):
    _fixed_source(monkeypatch)
    result, outcome = _run(2 ** 31 + 44, _stragglers_held_to_the_end)
    assert result["checks"]["bytes_wrong"]["value"] == 0
    assert result["checks"]["volumes_left_open"]["value"] == FED - 2
    assert result["correct"] is False and result["failed"] == FED - 2


def test_the_control_is_not_correct(monkeypatch):
    _fixed_source(monkeypatch)
    result, _ = _run(2 ** 31 + 45, breakers.control)
    assert result["correct"] is False
    assert result["checks"]["bytes_wrong"]["value"] > 0


@pytest.mark.cuda
def test_the_cell_is_correct_on_the_card_traced(card):
    result, outcome = harness.run(CELL, 2 ** 31 + 46, 2.0, True,
                                  time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0
    metrics = result["metrics"]
    assert 0 < metrics["kernel_roofline.seal"]["value"] <= 100
    assert metrics["split_pack_gibps.seal"]["value"] > 0
    assert outcome.info[hostspans.KEY]["dropped"] == 0
    assert outcome.info["split_chunks"] == 2 * 161 * outcome.info["volumes"]
