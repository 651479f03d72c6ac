"""``correct`` comes out false under the control and under every fault a
cell can have, with the rest of a run driven as the command drives it
(the look for a card skipped); and true with the program."""

import time

import pytest

from portbench import breakers, harness
from portbench.tests import tiny


def _run(cell, seed, root, patch=None, everything=True):
    with tiny.small_batches():
        result, _ = harness.run(
            cell, seed, 0.2, False, time.perf_counter(), device="cpu",
            patch=patch or harness.contextlib.nullcontext,
            overrides=tiny.overrides(cell, everything),
            root=tiny.root_for(cell, root))
    return result


@pytest.mark.parametrize("cell", ["seal_backlog_30mib", tiny.READ_CELL])
def test_the_program_is_correct(cell, tmp_path):
    assert _run(cell, 2 ** 31 + 1, tmp_path)["correct"] is True


@pytest.mark.parametrize("cell", ["seal_backlog_30mib", tiny.READ_CELL])
def test_the_control_is_not_correct(cell, tmp_path):
    res = _run(cell, 2 ** 31 + 2, tmp_path, breakers.control,
               everything=False)
    assert res["correct"] is False
    wrong = "bytes_wrong" if cell.startswith("seal") else "reads_wrong"
    assert res["checks"][wrong]["value"] > 0


@pytest.mark.parametrize("fault", breakers.FAULTS)
@pytest.mark.parametrize("cell", ["seal_backlog_30mib", tiny.READ_CELL])
def test_each_fault_is_not_correct(cell, fault, tmp_path):
    res = _run(cell, 2 ** 31 + 3, tmp_path, lambda: breakers.fault(fault))
    assert res["correct"] is False, res["checks"]


def test_the_breakers_put_the_codec_back():
    from seaweedfs_tpu_torch.ops import rs_torch
    before = dict(rs_torch.Encoder.__dict__)
    with breakers.control():
        assert rs_torch.Encoder.__dict__["encode_parity_host"] is not \
            before["encode_parity_host"]
    with breakers.fault("half"):
        pass
    for name in ("encode_parity_host", "encode_parity_host_multi",
                 "reconstruct_batch_host"):
        assert rs_torch.Encoder.__dict__[name] is before[name]
