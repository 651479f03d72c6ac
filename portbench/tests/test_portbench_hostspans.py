"""The card's idle time put down to the pipeline's host stages
(portbench/hostspans.py) and the four readers of it: the attribution on
synthetic intervals, the readers on the tiny CPU seal cells, and on the
card each seal cell traced over a short window."""

import json
import time

import pytest

from portbench import harness, hostspans, trace
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


def test_each_idle_gap_is_labelled_by_the_first_state_open_at_its_middle():
    states = {"dispatch": _ms((0, 50)), "reader_wait": _ms((12, 18)),
              "h2d": _ms((14, 16)), "group_wait": _ms((30, 39.5))}
    gaps = [(a * 1e3, b * 1e3, op) for a, b, op in (
        (10, 20, "Memcpy HtoD"),       # middle 15: h2d beats the rest
        (30, 40, "Memcpy HtoD"),       # 35: group_wait beats dispatch
        (32, 38, "kernel"),            # 35 again, another operation
        (40, 46, "Memcpy DtoH"),       # 43: dispatch alone
        (50, 60, "end of window"))]    # 55: under no span
    got = dict(trace._label_gaps(gaps, states))
    assert got == {
        "h2d -> Memcpy HtoD (1 gaps)": pytest.approx(0.010),
        "group_wait -> Memcpy HtoD (1 gaps)": pytest.approx(0.010),
        "group_wait -> kernel (1 gaps)": pytest.approx(0.006),
        "dispatch -> Memcpy DtoH (1 gaps)": pytest.approx(0.006),
        "none -> end of window (1 gaps)": pytest.approx(0.010)}
    assert list(got)[0].startswith(("h2d", "group_wait", "none"))
    unringed = trace._label_gaps(gaps[:2], None)
    assert unringed == [["no ring -> Memcpy HtoD (2 gaps)",
                         pytest.approx(0.020)]]


class _Profile:
    """A finished profile that exports a fixed chrome trace."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def test_the_labels_sum_to_the_idle_seconds_device_idle_reads(monkeypatch):
    from seaweedfs_tpu_torch.pipeline import flight
    w0, t0 = 1_000_000.0, 50.0       # the trace's µs at host second 50
    # 24 kernels of 1 ms, one every 4 ms, each under its own name: 24
    # labels, more than the breakdown keeps, so the rest fold into one
    ops = [{"ph": "X", "cat": "kernel", "name": f"op{i}",
            "ts": w0 + 4e3 * i + 2e3, "dur": 1e3} for i in range(24)]
    mark = {"ph": "X", "cat": "user_annotation", "name": "pb.window",
            "ts": w0, "dur": 100e3}
    # the group drain waits over the first 40 ms of the window
    ring = [("group_wait", int(t0 * 1e9), int((t0 + 0.040) * 1e9), 1, -1),
            ("h2d", int((t0 + 0.060) * 1e9), int((t0 + 0.070) * 1e9), 1,
             flight.STAGED)]
    monkeypatch.setattr(flight, "recorder",
                        lambda: type("Ring", (), {"dropped": 0})())
    monkeypatch.setattr(flight, "spans", lambda: ring)
    w = trace.Window(True, True)
    w._t0, w._prof = t0, _Profile([mark] + ops)
    reading = w.reading = w._read()
    labels = reading.idle_gaps
    assert len(labels) == trace.TOP and labels[-1][0].startswith("other (")
    assert labels[0][0] == "none -> end of window (1 gaps)"
    states = {label.split(" -> ")[0] for label, _ in labels[:-1]}
    assert states <= {"group_wait", "h2d", "none"} and "group_wait" in states
    assert sum(int(label.rsplit("(", 1)[1].split()[0])
               for label, _ in labels) == 25
    idle_share = harness.load_metric("device_idle.seal").read(
        harness.Outcome(setup_s=1.0, attempted=1, failed=0, checks=[],
                        readings={"dat_bytes": 1}, window=w))
    idle_s = reading.window_s * idle_share / 100
    assert idle_s == pytest.approx(0.100 - 0.024)
    assert sum(s for _, s in labels) == pytest.approx(idle_s, rel=1e-9)


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
