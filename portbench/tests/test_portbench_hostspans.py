"""The card's idle time put down to the pipeline's host stages
(portbench/hostspans.py) and the four readers of it: the attribution on
synthetic intervals, the readers on the tiny CPU seal cells, and on the
card each seal cell traced over a short window."""

import time

import pytest

from portbench import harness, hostspans
from portbench.tests import tiny

READERS = ("pack_busy.seal", "idle_reader_wait.seal",
           "idle_group_wait.seal", "idle_h2d_stage.seal")


def _ms(*pairs):
    return [(a * 1e3, b * 1e3) for a, b in pairs]


def test_each_idle_stretch_goes_to_the_first_state_open_at_its_middle():
    # the card is busy over [0, 10], [20, 30] and [40, 40.5] ms of
    # [0, 50]: idle [10, 20], [30, 40] and [40.5, 50]
    busy = _ms((0, 10), (20, 30), (40, 40.5))
    spans = {"dispatch": _ms((5, 50)),          # open over everything
             "reader_wait": _ms((12, 18)),       # holds 15: beats dispatch
             "h2d": _ms((14, 16), (31, 39)),     # holds 15 and 35
             "group_wait": _ms((30, 39.5))}      # holds 35, loses to h2d
    got = hostspans.attribute(busy, spans, 0.0, 50e3)
    assert got["gaps"] == 3
    assert got["idle"]["h2d"] == pytest.approx(0.020)
    assert got["idle"]["dispatch"] == pytest.approx(0.0095)
    assert got["idle"]["reader_wait"] == got["idle"]["group_wait"] == 0.0
    assert got["idle"]["none"] == 0.0
    assert got["window_s"] == pytest.approx(0.050)


def test_an_idle_stretch_under_no_span_goes_to_none():
    got = hostspans.attribute(_ms((10, 20)), {"reader_wait": _ms((0, 4))},
                              0.0, 30e3)
    # [0, 10] has its middle at 5, past the wait; [20, 30] under nothing
    assert got["idle"]["none"] == pytest.approx(0.020)
    assert got["idle"]["reader_wait"] == 0.0


def test_the_states_sum_to_the_idle_share_and_busy_is_clipped():
    busy = _ms((-5, 3), (2, 7), (6, 9), (12, 13), (48, 60))
    spans = {"reader_wait": _ms((8, 20)), "group_wait": _ms((25, 30))}
    got = hostspans.attribute(busy, spans, 0.0, 50e3)
    busy_s = (9 + 1 + 2) / 1e3
    assert got["idle_s"] == pytest.approx(0.050 - busy_s)
    assert sum(got["idle"].values()) == pytest.approx(got["idle_s"])
    assert got["idle"]["reader_wait"] == pytest.approx(0.003)
    assert got["idle"]["none"] == pytest.approx(0.035)
    assert hostspans.attribute([], {}, 0.0, 1e3)["idle"]["none"] == \
        pytest.approx(1e-3)


def test_ring_spans_are_placed_by_the_shared_clock_and_h2d_is_the_staging():
    staged, t0, w0 = -2, 100.0, 5_000.0     # host clock 100 s at w0 µs
    ring = [("h2d", 100_001_000_000, 100_002_000_000, 7, staged),
            ("h2d", 100_003_000_000, 100_004_000_000, 7, 3),  # mesh prepare
            ("dispatch", 100_000_500_000, 100_004_500_000, 7, 3),
            ("pack", 100_000_000_000, 100_001_000_000, 8, -1),
            ("read", 100_000_000_000, 100_001_000_000, 8, 3)]
    got = hostspans.placed(ring, staged, t0, w0)
    assert set(got) == {"h2d", "dispatch"}
    assert got["h2d"] == [pytest.approx((w0 + 1e3, w0 + 2e3))]
    assert got["dispatch"] == [pytest.approx((w0 + 500, w0 + 4.5e3))]


class _Event:
    """A profiler event as torch 2.11 (no ``activity_type``) or 2.13 has
    it."""

    def __init__(self, device, annotation=False, cat=None):
        self.device_type = type("DeviceType", (), {"name": device})
        self.is_user_annotation = annotation
        if cat is not None:
            self.activity_type = cat


def test_device_ops_are_the_cards_kernels_and_copies_in_either_torch():
    new = [(_Event("CUDA", cat=c), c in ("kernel", "gpu_memcpy"))
           for c in ("kernel", "gpu_memcpy", "gpu_user_annotation",
                     "cuda_sync")]
    new.append((_Event("CPU", annotation=True, cat="user_annotation"),
                False))
    old = [(_Event("CUDA"), True), (_Event("CUDA", annotation=True), False),
           (_Event("CPU"), False)]
    for e, want in new + old:
        assert hostspans._device_op(e) is want


@pytest.mark.parametrize("cell", tiny.SEAL_CELLS)
def test_only_pack_busy_reads_on_the_cpu(cell):
    with tiny.small_batches():
        _, outcome = harness.run(cell, 2 ** 31 + 11, 0.3, True,
                                 time.perf_counter(), device="cpu",
                                 overrides=tiny.overrides(cell))
    got = {n: harness.load_metric(n).read(outcome) for n in READERS}
    assert got.pop("pack_busy.seal") > 0
    assert got == dict.fromkeys(got)
    assert outcome.info[hostspans.KEY] is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.SEAL_CELLS)
def test_a_traced_seal_on_the_card_puts_all_its_idle_down(card, cell):
    result, outcome = harness.run(cell, 2 ** 31 + 12, 2.0, True,
                                  time.perf_counter())
    assert result["correct"] is True, result["checks"]
    metrics = result["metrics"]
    assert set(READERS) <= set(metrics)
    got = outcome.info[hostspans.KEY]
    assert got["dropped"] == 0
    assert sum(got["idle"].values()) == pytest.approx(got["idle_s"])
    share = 100.0 * got["idle_s"] / got["window_s"]
    assert abs(share - metrics["device_idle.seal"]["value"]) <= 1.0
