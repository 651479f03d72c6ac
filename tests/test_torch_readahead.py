"""The port's sequential read-ahead (``cache/readahead.py``) and disk-tier
hot-forward compaction (``cache/disk_tier.py``) against the JAX
package's, on the CPU.

Every case of ``tests/test_readahead.py`` runs on both packages, with
the same expectations. The JAX file's two ``ReadPages`` cases drive the
window and the prefetcher through the FUSE page cache, which the port
does not have yet (ROADMAP Queue 1, the remaining front ends); here they
drive the same window and prefetcher through the S3 gateway's ranged
read-through (``S3Gateway._ranged_read``), the port's consumer of
read-ahead, over a stub filer. One more case holds the two packages'
windows to equal plans over one seeded stream of reads."""

import threading
import time

import numpy as np
import pytest

from seaweedfs_tpu.cache import disk_tier as jax_disk_tier
from seaweedfs_tpu.cache import readahead as jax_readahead
from seaweedfs_tpu.cache.chunk_cache import ChunkCache as JaxChunkCache
from seaweedfs_tpu.gateway import s3 as jax_s3
from seaweedfs_tpu_torch.cache import disk_tier, readahead
from seaweedfs_tpu_torch.cache.chunk_cache import ChunkCache
from seaweedfs_tpu_torch.gateway import s3
from torch_teardown import collect_jax_garbage  # noqa: F401

UNIT = 1024
PKG = {"jax": dict(ra=jax_readahead, dt=jax_disk_tier, s3=jax_s3,
                   cache=JaxChunkCache),
       "port": dict(ra=readahead, dt=disk_tier, s3=s3, cache=ChunkCache)}


@pytest.fixture(params=sorted(PKG))
def pkg(request):
    return PKG[request.param]


def _win(ra, **kw):
    kw.setdefault("unit", UNIT)
    kw.setdefault("initial_units", 2)
    kw.setdefault("max_units", 8)
    kw.setdefault("confirm", 2)
    return ra.ReadaheadWindow(**kw)


# ---------------------------------------------------------------------------
# ReadaheadWindow
# ---------------------------------------------------------------------------

def test_window_needs_confirmation_before_opening(pkg):
    w = _win(pkg["ra"])
    assert w.observe(0, UNIT) is None
    assert w.observe(UNIT, UNIT) is None
    plan = w.observe(2 * UNIT, UNIT)
    assert plan is not None and w.is_open
    assert plan == (3 * UNIT, 2 * UNIT)
    w.close()


def test_window_doubles_as_reader_catches_up(pkg):
    w = _win(pkg["ra"])
    w.observe(0, UNIT)
    w.observe(UNIT, UNIT)
    w.observe(2 * UNIT, UNIT)
    seen = [w.window_units]
    off = 3 * UNIT
    for _ in range(12):
        w.observe(off, UNIT)
        off += UNIT
        seen.append(w.window_units)
    assert seen[0] == 2
    assert max(seen) == 8
    assert sorted(set(seen)) == [2, 4, 8]
    w.close()


def test_window_seek_resets_streak(pkg):
    w = _win(pkg["ra"])
    w.observe(0, UNIT)
    w.observe(UNIT, UNIT)
    assert w.observe(2 * UNIT, UNIT) is not None
    assert w.observe(100 * UNIT, UNIT) is None
    assert not w.is_open
    assert w.observe(101 * UNIT, UNIT) is None
    assert w.observe(102 * UNIT, UNIT) is not None
    w.close()


def test_window_tolerates_tail_page_rereads(pkg):
    w = _win(pkg["ra"])
    w.observe(0, UNIT)
    w.observe(UNIT, UNIT // 2)
    assert w.observe(UNIT + UNIT // 2, UNIT) is not None
    w.close()


def test_window_clamps_at_eof(pkg):
    w = _win(pkg["ra"])
    size = 4 * UNIT
    w.observe(0, UNIT, size)
    w.observe(UNIT, UNIT, size)
    plan = w.observe(2 * UNIT, UNIT, size)
    assert plan is not None
    start, nbytes = plan
    assert start + nbytes <= size
    assert w.observe(3 * UNIT, UNIT, size) is None
    w.close()


def test_window_never_replans_prefetched_spans(pkg):
    w = _win(pkg["ra"])
    w.observe(0, UNIT)
    w.observe(UNIT, UNIT)
    s1, n1 = w.observe(2 * UNIT, UNIT)
    plan2 = w.observe(3 * UNIT, UNIT)
    if plan2 is not None:
        assert plan2[0] >= s1 + n1
    w.close()


def test_window_open_count_tracks_close(pkg):
    ra = pkg["ra"]
    before = ra.stats()["windows_open"]
    w = _win(ra)
    w.observe(0, UNIT)
    w.observe(UNIT, UNIT)
    w.observe(2 * UNIT, UNIT)
    assert ra.stats()["windows_open"] == before + 1
    w.close()
    assert ra.stats()["windows_open"] == before


def test_windows_plan_alike_over_one_seeded_stream():
    """One stream of sequential runs, tail re-reads and seeks, with and
    without a size: every plan and window width equal between the
    packages."""
    rng = np.random.default_rng(3)
    reads, off = [], 0
    for _ in range(400):
        r = rng.random()
        if r < 0.08:
            off = int(rng.integers(0, 400)) * UNIT
        elif r < 0.15:
            off = max(0, off - int(rng.integers(1, UNIT)))
        ln = int(rng.integers(1, 3 * UNIT))
        reads.append((off, ln))
        off += ln
    for size in (None, 300 * UNIT):
        ws = {name: _win(p["ra"], max_units=16) for name, p in PKG.items()}
        for off, ln in reads:
            got = {name: (w.observe(off, ln) if size is None
                          else w.observe(off, ln, size), w.window_units,
                          w.is_open)
                   for name, w in ws.items()}
            assert got["port"] == got["jax"], (off, ln, size)
        for w in ws.values():
            w.close()


# ---------------------------------------------------------------------------
# Prefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_runs_and_dedupes(pkg):
    p = pkg["ra"].Prefetcher(workers=1, depth=8)
    ran = []
    gate = threading.Event()
    done = threading.Event()

    def slow():
        gate.wait(5)
        ran.append("slow")

    def fast():
        ran.append("fast")
        done.set()

    assert p.submit("k1", slow)
    assert not p.submit("k1", fast)
    assert p.submit("k2", fast)
    gate.set()
    assert done.wait(5)
    for _ in range(100):
        if p.pending() == 0:
            break
        time.sleep(0.01)
    assert "slow" in ran and "fast" in ran
    assert p.submit("k1", fast)


def test_prefetcher_sheds_when_saturated(pkg):
    ra = pkg["ra"]
    p = ra.Prefetcher(workers=1, depth=1)
    gate = threading.Event()
    before = ra.stats()["prefetch_dropped"]
    assert p.submit("a", gate.wait)
    deadline = time.time() + 5
    i = 0
    dropped = False
    while time.time() < deadline and not dropped:
        i += 1
        if not p.submit(f"b{i}", lambda: None):
            dropped = True
    gate.set()
    assert dropped, "saturated queue must shed, not block"
    assert ra.stats()["prefetch_dropped"] > before


# ---------------------------------------------------------------------------
# the gateway's ranged read-through: sequential reads hit the prefetch
# ---------------------------------------------------------------------------

class _StubFiler:
    """What ``_ranged_read`` asks of a filer client: ``get_data``."""

    def __init__(self, blob: bytes, delay: float = 0.0):
        self.blob, self.delay = blob, delay
        self.fetched = []
        self._lock = threading.Lock()

    def get_data(self, path, offset=0, length=None):
        with self._lock:
            self.fetched.append((offset, length))
        time.sleep(self.delay)
        end = len(self.blob) if length is None else offset + length
        return self.blob[offset:end]

    def close(self):
        pass


def _gateway(pkg, blob, delay=0.0):
    gw = pkg["s3"].S3Gateway("127.0.0.1:1", port=0)
    gw.filer.close()
    gw.filer = _StubFiler(blob, delay)
    return gw, pkg["cache"](64 << 20)


def test_ranged_read_sequential_prefetch_hits(pkg):
    ra = pkg["ra"]
    bs = pkg["s3"].S3Gateway.RANGE_BLOCK
    size = 24 * bs + 17
    blob = np.random.default_rng(1).integers(0, 256, size,
                                             dtype=np.uint8).tobytes()
    gw, cache = _gateway(pkg, blob, delay=0.002)
    before = ra.stats()
    step = bs // 2
    for off in range(0, 8 * bs, step):
        assert gw._ranged_read(cache, "/o", "e1", size, off, step) == \
            blob[off:off + step]
    # wait for the prefetcher to land a block ahead of the reader
    deadline = time.time() + 10
    while time.time() < deadline:
        with gw._ra_lock:
            if gw._ra_prefetched:
                break
        time.sleep(0.005)
    with gw._ra_lock:
        landed = sorted(int(k.rsplit(":", 1)[1])
                        for k in gw._ra_prefetched)
    assert landed, "prefetcher never landed a block"
    b = landed[0]
    hits = ra.stats()["prefetch_hits"]
    assert gw._ranged_read(cache, "/o", "e1", size, b * bs, bs) == \
        blob[b * bs:(b + 1) * bs]
    after = ra.stats()
    assert after["prefetch_hits"] > hits
    assert after["windows_opened"] > before["windows_opened"]
    assert after["prefetch_bytes"] > before["prefetch_bytes"]


def test_ranged_read_random_reads_stay_quiet(pkg):
    ra = pkg["ra"]
    bs = pkg["s3"].S3Gateway.RANGE_BLOCK
    size = 64 * bs
    blob = b"z" * size
    gw, cache = _gateway(pkg, blob)
    before = ra.stats()
    for blk in (0, 30, 5, 60, 12):
        assert gw._ranged_read(cache, "/r", "e2", size, blk * bs,
                               bs) == blob[blk * bs:(blk + 1) * bs]
    time.sleep(0.05)
    after = ra.stats()
    assert after["prefetch_hits"] == before["prefetch_hits"]
    assert after["prefetch_bytes"] == before["prefetch_bytes"]
    assert not gw._ra_prefetched
    assert gw.filer.fetched == [(blk * bs, bs) for blk in (0, 30, 5, 60, 12)]


# ---------------------------------------------------------------------------
# DiskTier hot-forward compaction
# ---------------------------------------------------------------------------

def _get(tier, key):
    hit = tier.get(key)
    return None if hit is None else hit[0]


def _fill_until_rotation(tier, start, payload, count):
    for i in range(start, start + count):
        tier.put(f"cold-{i}", payload)
    return start + count


def _tier(pkg, path, compaction=True):
    return pkg["dt"].DiskTier(path, capacity_bytes=16 * 4096 * 4,
                              segments=4, compaction=compaction)


@pytest.mark.parametrize("compaction", [True, False])
def test_hot_record_survival_depends_on_compaction(tmp_path, pkg,
                                                   compaction):
    payload = b"x" * 4096
    tier = _tier(pkg, tmp_path / f"dt-{compaction}", compaction)
    tier.put("hot", payload)
    nxt = 0
    for _ in range(3):
        hit = _get(tier, "hot")
        if compaction:
            assert hit == payload
        nxt = _fill_until_rotation(tier, nxt, payload, 30)
    if compaction:
        assert _get(tier, "hot") == payload
        assert tier.compactions > 0
        assert tier.compaction_bytes_copied > 0
    else:
        assert _get(tier, "hot") is None
        assert tier.compactions == 0
    tier.close()


def test_unhit_record_is_not_copied_forward(tmp_path, pkg):
    payload = b"y" * 4096
    tier = _tier(pkg, tmp_path / "dt")
    tier.put("never-read", payload)
    for i in range(120):
        tier.put(f"cold-{i}", payload)
    assert _get(tier, "never-read") is None
    tier.close()


def test_compacted_heat_resets(tmp_path, pkg):
    payload = b"h" * 4096
    tier = _tier(pkg, tmp_path / "dt")
    tier.put("hot", payload)
    assert _get(tier, "hot") == payload
    nxt = _fill_until_rotation(tier, 0, payload, 30)
    assert _get(tier, "hot") == payload
    for _ in range(4):
        nxt = _fill_until_rotation(tier, nxt, payload, 30)
    assert _get(tier, "hot") is None
    tier.close()


def test_compacted_records_survive_restart(tmp_path, pkg):
    payload = b"r" * 4096
    tier = _tier(pkg, tmp_path / "dt")
    tier.put("hot", payload)
    assert _get(tier, "hot") == payload
    _fill_until_rotation(tier, 0, payload, 30)
    assert _get(tier, "hot") == payload
    tier.close()
    re = _tier(pkg, tmp_path / "dt")
    assert _get(re, "hot") == payload
    re.close()


def test_compacted_segments_reopen_in_the_other_package(tmp_path):
    """A disk tier that one package compacted opens in the other with
    the hot record intact, both ways."""
    payload = b"c" * 4096
    for a, b in (("port", "jax"), ("jax", "port")):
        d = tmp_path / f"{a}-to-{b}"
        tier = _tier(PKG[a], d)
        tier.put("hot", payload)
        assert _get(tier, "hot") == payload
        _fill_until_rotation(tier, 0, payload, 30)
        assert _get(tier, "hot") == payload
        tier.close()
        re = _tier(PKG[b], d)
        assert _get(re, "hot") == payload
        re.close()
