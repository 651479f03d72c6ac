"""The port's EC read path (seaweedfs_tpu_torch/pipeline/read.py), repair
aggregator (repair.py) and config-5 harness (repair_bench.py) against the
JAX package's, on the CPU.

A volume of real needles is sealed by the JAX package and read by both
packages' ``EcVolumeReader``s, whole and with shards 0, 5, 11 and 13
removed, with and without each package's aggregator. GF(2^8) coding is
exact, so every comparison is byte for byte (tolerance 0). The port's
small-payload rule is set so that some intervals go to the native host
codec and the others to the kernels' plain versions."""

import os
import shutil
import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu.pipeline import encode as jax_encode
from seaweedfs_tpu.pipeline import read as jax_read
from seaweedfs_tpu.pipeline import repair as jax_repair
from seaweedfs_tpu.pipeline import repair_bench as jax_repair_bench
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu.util import faults as jax_faults
from seaweedfs_tpu_torch.ops import rs_cuda, rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline import read, repair, repair_bench
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files, needle, volume
from seaweedfs_tpu_torch.util import faults, retry

GEOMETRY = dict(large_block_size=64 * 1024, small_block_size=8 * 1024)
SCHEME = EcScheme(10, 4, **GEOMETRY)
JAX_SCHEME = JaxScheme(10, 4, **GEOMETRY)
LOST = (0, 5, 11, 13)
SURVIVORS = [i for i in range(14) if i not in LOST]
#: 4 small rows: 32 KiB shards, intervals of 1 byte to 8 KiB
DAT_BYTES = 300_000
#: the port's threshold in these tests: intervals of 2 KiB and more take
#: the kernels' plain versions, shorter ones the host codec
MIN_S = 2048


@pytest.fixture
def min_s(monkeypatch):
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", MIN_S)
    return MIN_S


@pytest.fixture(scope="module")
def sealed(tmp_path_factory):
    """A JAX-sealed volume; its .dat stays as the truth."""
    base = tmp_path_factory.mktemp("sealed") / "v"
    n = volume.write_synthetic_volume(base, DAT_BYTES, avg_size=3000,
                                      seed=7)
    jax_encode.encode_volume(base, JAX_SCHEME)
    assert SCHEME.shard_file_size(os.path.getsize(str(base) + ".dat")) \
        == 32 * 1024
    return base, n


def _copy(base, dst, lost=()):
    """The sealed files under ``dst``, without the ``lost`` shards."""
    os.makedirs(dst, exist_ok=True)
    for ext in [ec_files.shard_ext(i) for i in range(14)] + [
            ".ecx", ".vif", ".dat"]:
        if ext in {ec_files.shard_ext(i) for i in lost}:
            continue
        shutil.copy(str(base) + ext, os.path.join(dst, "v" + ext))
    return os.path.join(dst, "v")


def _truth(base, key):
    """Needle ``key``'s record bytes from the original .dat."""
    r = read.EcVolumeReader(base, SCHEME, device="cpu")
    e = r.lookup(key)
    size = needle.record_size(e.size, r.version)
    with open(str(base) + ".dat", "rb") as f:
        f.seek(e.byte_offset)
        return f.read(size)


class _Calls:
    """Counts the host codec's calls and the plain-version calls made
    through ``rs_cuda.apply_gf_matrix`` (the CPU's kernel route)."""

    def __init__(self, monkeypatch):
        self.plain = 0
        real = rs_cuda.apply_gf_matrix

        def spy(coefs, x):
            self.plain += 1
            return real(coefs, x)

        monkeypatch.setattr(rs_cuda, "apply_gf_matrix", spy)
        self.native0 = rs_native.apply_gf_matrix.calls

    @property
    def native(self):
        return rs_native.apply_gf_matrix.calls - self.native0


def _read_all(reader, keys, threads=1):
    if threads == 1:
        return {k: reader.read_record(k) for k in keys}
    out, errs = {}, []

    def work(part):
        try:
            for k in part:
                out[k] = reader.read_record(k)
        except Exception as e:  # noqa: BLE001 — checked below
            errs.append(e)

    ts = [threading.Thread(target=work, args=(keys[i::threads],))
          for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs
    return out


@pytest.mark.parametrize("aggregated", [False, True],
                         ids=["direct", "aggregator"])
@pytest.mark.parametrize("lost", [(), LOST], ids=["whole", "lost4"])
def test_readers_agree_across_packages(sealed, tmp_path, monkeypatch, min_s,
                                       lost, aggregated):
    base, n = sealed
    vol = _copy(base, tmp_path / "v", lost)
    keys = list(range(1, n + 1))
    calls = _Calls(monkeypatch)
    if aggregated:
        with repair.IntervalRepairAggregator(SCHEME, device="cpu",
                                             max_wait_s=0.005) as agg, \
                jax_repair.IntervalRepairAggregator(
                    JAX_SCHEME, max_wait_s=0.005) as jagg:
            port = read.EcVolumeReader(vol, SCHEME, aggregator=agg,
                                       device="cpu")
            jax = jax_read.EcVolumeReader(vol, JAX_SCHEME, aggregator=jagg)
            got = _read_all(port, keys, threads=4)
            want = _read_all(jax, keys, threads=4)
            assert agg.requests == port.intervals_repaired
            assert agg.batches <= agg.requests
            # one codec call per batch, on the route its padded length picks
            assert calls.native + calls.plain == agg.batches
    else:
        port = read.EcVolumeReader(vol, SCHEME, device="cpu")
        jax = jax_read.EcVolumeReader(vol, JAX_SCHEME)
        got = _read_all(port, keys)
        want = _read_all(jax, keys)
    assert got == want
    assert port.intervals_repaired == jax.intervals_repaired
    for k in keys:
        assert got[k] == _truth(vol, k)
    assert port.read_needle(n).data == jax.read_needle(n).data
    if lost:
        assert port.intervals_repaired > 0
        if not aggregated:
            # intervals below MIN_S on the host codec, the others on the
            # kernels' plain versions
            assert calls.native > 0 and calls.plain > 0
            assert calls.native + calls.plain == port.intervals_repaired
    else:
        assert port.intervals_repaired == 0
        assert calls.native == calls.plain == 0


@pytest.mark.parametrize("spec", ["error#3", "truncate:0.5#2"],
                         ids=["check", "mangle"])
def test_a_damaged_shard_read_degrades_alike(sealed, tmp_path, min_s, spec):
    base, n = sealed
    vol = _copy(base, tmp_path / "v")
    port = read.EcVolumeReader(vol, SCHEME, device="cpu")
    jax = jax_read.EcVolumeReader(vol, JAX_SCHEME)
    before = retry.degraded_counts().get("ec_reconstruct", 0)
    got, want = {}, {}
    try:
        faults.inject("ec.shard_read", spec, seed=1)
        jax_faults.inject("ec.shard_read", spec, seed=1)
        for k in (1, 2, n):
            got[k] = port.read_record(k)
            want[k] = jax.read_record(k)
    finally:
        faults.clear()
        jax_faults.clear()
    assert got == want
    assert all(got[k] == _truth(vol, k) for k in got)
    assert port.intervals_repaired == jax.intervals_repaired > 0
    assert retry.degraded_counts()["ec_reconstruct"] - before \
        == port.intervals_repaired


def test_delete_needle_writes_the_same_ecj(sealed, tmp_path):
    base, _ = sealed
    a = _copy(base, tmp_path / "a")
    b = _copy(base, tmp_path / "b")
    port = read.EcVolumeReader(a, SCHEME, device="cpu")
    jax = jax_read.EcVolumeReader(b, JAX_SCHEME)
    for key in (5, 3, 11):
        port.delete_needle(key)
        jax.delete_needle(key)
    assert open(a + ".ecj", "rb").read() == open(b + ".ecj", "rb").read()
    for reader in (port, read.EcVolumeReader(a, SCHEME, device="cpu")):
        with pytest.raises(KeyError):
            reader.read_needle(5)
    with pytest.raises(KeyError):
        port.delete_needle(10**9)


def test_too_few_shards_raises(sealed, tmp_path):
    base, _ = sealed
    vol = _copy(base, tmp_path / "v", lost=(0, 1, 2, 3, 4))
    with pytest.raises(read.TooFewShardsError):
        read.EcVolumeReader(vol, SCHEME, device="cpu").read_record(1)


def _burst_fixture(shard_len=2048, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (10, shard_len), dtype=np.uint8)
    parity = SCHEME.encoder("cpu").encode_parity(data).numpy()
    return np.concatenate([data, parity], axis=0)


def test_aggregator_burst_matches_jax(monkeypatch, min_s):
    """tests/test_repair.py's burst (mixed sizes and wanted shards, 40
    threads, released at once) through both aggregators: the same bytes,
    and batching."""
    shards = _burst_fixture()
    calls = _Calls(monkeypatch)
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(40):
        want = LOST[int(rng.integers(4))]
        off = int(rng.integers(0, 1500))
        size = int(rng.integers(1, 500))
        reqs.append((want, off, size))
    results = {"port": {}, "jax": {}}
    errs = []
    go = threading.Barrier(2 * len(reqs))
    with repair.IntervalRepairAggregator(SCHEME, device="cpu",
                                         max_wait_s=0.005) as agg, \
            jax_repair.IntervalRepairAggregator(JAX_SCHEME,
                                                max_wait_s=0.005) as jagg:
        def one(name, a, i, want, off, size):
            try:
                go.wait(timeout=30)
                results[name][i] = a.repair(
                    SURVIVORS, shards[SURVIVORS, off:off + size], want)
            except Exception as e:  # noqa: BLE001 — checked below
                errs.append(e)

        ts = [threading.Thread(target=one, args=(name, a, i, *r))
              for i, r in enumerate(reqs)
              for name, a in (("port", agg), ("jax", jagg))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    assert not errs, errs
    for i, (want, off, size) in enumerate(reqs):
        np.testing.assert_array_equal(results["port"][i],
                                      results["jax"][i])
        np.testing.assert_array_equal(results["port"][i],
                                      shards[want, off:off + size])
    assert agg.requests == len(reqs)
    assert agg.batches < agg.requests
    # every request is shorter than MIN_S: one host-codec call per batch
    assert calls.native == agg.batches and calls.plain == 0


def test_repair_bench_returns_the_jax_keys(tmp_path):
    kw = dict(duration_s=1.0, qps=64, shard_len=1 << 20,
              interval_size=4096, bulk_chunk=64 * 1024)
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    res = repair_bench.run(scheme=SCHEME, device="cpu",
                           workdir=str(tmp_path / "port"), **kw)
    jres = jax_repair_bench.run(scheme=JAX_SCHEME,
                                workdir=str(tmp_path / "jax"),
                                **dict(kw, duration_s=0.3))
    assert sorted(res) == sorted(jres)
    assert res["reads"] > 10 and res["agg_requests"] >= res["reads"]
    assert res["bulk_chunks"] >= 4 and res["decode_gibps"] > 0
    assert 0 < res["read_p50_ms"] <= res["read_p99_ms"]


def test_repair_bench_reports_a_wrong_repair(tmp_path, monkeypatch):
    """A reconstruct that returns wrong bytes fails the run."""
    real = rs_torch.Encoder.reconstruct_batch_host

    def wrong(self, shards, present, wanted=None):
        return np.asarray(real(self, shards, present, wanted)) ^ 1

    monkeypatch.setattr(rs_torch.Encoder, "reconstruct_batch_host", wrong)
    with pytest.raises((RuntimeError, AssertionError), match="mismatch"):
        repair_bench.run(duration_s=0.5, shard_len=256 * 1024,
                         bulk_chunk=64 * 1024, scheme=SCHEME, device="cpu",
                         workdir=str(tmp_path))


def test_entry_points_refuse_the_cpu_without_cuda(sealed, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    base, _ = sealed
    for call in (lambda: read.EcVolumeReader(base, SCHEME),
                 lambda: repair.IntervalRepairAggregator(SCHEME),
                 lambda: repair_bench.run(duration_s=0.1,
                                          shard_len=4096, scheme=SCHEME,
                                          workdir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())
