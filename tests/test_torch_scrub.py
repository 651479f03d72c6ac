"""The port's scrubber (seaweedfs_tpu_torch/storage/scrubber.py) against
the JAX package's, on the CPU.

The same JAX-written volume and the same JAX-sealed RS(10,4) volume, with
the same injected rot, go through both packages' ``scrub_volume`` and
``scrub_ec``: the result dicts must be equal with quarantine paths and
times masked, the ``.scrub`` sidecars' ``shard_sha256`` equal, and the
rebuilt shards byte-equal (tolerance 0). The pacer cases mirror
tests/test_scrub.py. The port's parity proof and rebuild run through
the host codec below ``DEVICE_MIN_S`` and through the kernels' plain
versions when it is lowered to 0."""

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from seaweedfs_tpu.pipeline.encode import encode_volume as jax_encode_volume
from seaweedfs_tpu.pipeline.scheme import EcScheme as JaxScheme
from seaweedfs_tpu.storage import scrubber as jax_scrubber
from seaweedfs_tpu.storage import volume as jax_volume
from seaweedfs_tpu_torch.ops import rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files, scrubber
from seaweedfs_tpu_torch.storage import volume as port_volume
from torch_teardown import collect_jax_garbage  # noqa: F401

GEOMETRY = dict(data_shards=10, parity_shards=4, large_block_size=2048,
                small_block_size=256)
SCRUB = {"jax": (jax_scrubber, JaxScheme(**GEOMETRY), jax_volume, {}),
         "port": (scrubber, EcScheme(**GEOMETRY), port_volume,
                  {"device": "cpu"})}


@pytest.fixture(params=["host", "plain"])
def codec(request, monkeypatch):
    """The port's products: the native host codec (shards below
    DEVICE_MIN_S), or the kernels' plain versions (DEVICE_MIN_S 0)."""
    if request.param == "plain":
        monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 0)
    return request.param


def _counter(mod, name, **labels):
    return mod.METRICS.counter(name, **labels).value


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _masked(res: dict, root) -> dict:
    """A result dict with quarantine paths made relative to ``root``."""
    out = dict(res)
    if "quarantined" in out:
        out["quarantined"] = [os.path.relpath(p, root)
                              for p in out["quarantined"]]
    return out


def _sidecar(base) -> dict:
    """The .scrub sidecar with its times masked."""
    st = json.loads(Path(str(base) + ".scrub").read_bytes())
    for section in ("volume", "ec"):
        if section in st:
            st[section]["last_scrub_unix"] = "<time>"
    return st


def _copies(tmp_path, make) -> dict:
    """``make(seed_dir)`` once, then one copy of it per package."""
    seed = tmp_path / "seed"
    seed.mkdir()
    make(seed)
    roots = {}
    for name in SCRUB:
        roots[name] = tmp_path / name
        shutil.copytree(seed, roots[name])
    return roots


# -- pacer ------------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(SCRUB))
def test_rate_pacer_budgets_bytes(pkg):
    mod = SCRUB[pkg][0]
    clock = [0.0]
    slept = []

    def sleep(s):
        slept.append(s)
        clock[0] += s

    p = mod.RatePacer(1000, clock=lambda: clock[0], sleep=sleep)
    p.take(1000)        # consumes the initial 1s burst allowance
    p.take(500)         # over budget -> must wait 0.5s
    assert slept and abs(sum(slept) - 0.5) < 1e-6
    assert abs(p.slept_seconds - 0.5) < 1e-6


@pytest.mark.parametrize("pkg", list(SCRUB))
def test_rate_pacer_zero_rate_never_sleeps(pkg):
    p = SCRUB[pkg][0].RatePacer(0, sleep=lambda s: pytest.fail("slept"))
    for _ in range(100):
        p.take(1 << 20)


def test_pacer_schedules_equal_jax(monkeypatch):
    """The same takes on the same clock sleep the same amounts in both
    packages, at the default rate a pacer takes when none is named."""
    monkeypatch.setattr(jax_scrubber, "_RATE_BYTES_PER_SECOND",
                        jax_scrubber._DEFAULT_RATE)
    sleeps = {}
    for name, (mod, _s, _v, _kw) in SCRUB.items():
        clock = [0.0]
        got = []

        def sleep(s, clock=clock, got=got):
            got.append(s)
            clock[0] += s

        p = mod.RatePacer(None, clock=lambda c=clock: c[0], sleep=sleep)
        assert p.rate == 8 * 1024 * 1024
        for n in (4 << 20, 4 << 20, 3 << 20, 9 << 20, 1):
            p.take(n)
            clock[0] += 0.25
        sleeps[name] = (got, p.slept_seconds)
    assert sleeps["port"] == sleeps["jax"]
    assert sleeps["port"][0]                 # the schedule did sleep
    assert (scrubber.DEFAULT_RATE_BYTES_PER_SECOND
            == jax_scrubber._DEFAULT_RATE)


# -- plain-volume scrub -----------------------------------------------------


def _plain_volume(seed_dir):
    jax_volume.generate_synthetic_volume(seed_dir / "1", 1, n_needles=12,
                                         avg_size=256, seed=7).close()


def test_scrub_clean_volume_equals_jax(tmp_path):
    roots = _copies(tmp_path, _plain_volume)
    out = {}
    for name, (mod, _s, vol_mod, _kw) in SCRUB.items():
        with vol_mod.Volume(roots[name] / "1", 1).load() as vol:
            res = mod.scrub_volume(vol, mod.RatePacer(0))
        assert res["checked"] == 12 and res["corrupt"] == 0
        out[name] = (res, _sidecar(roots[name] / "1"))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("fetch", [True, False])
def test_scrub_rotten_needle_equals_jax(tmp_path, fetch):
    """Bit-rot inside one needle's body: detected, its record
    quarantined, and (with a replica fetcher) repaired to byte-identical
    data, with the same result, sidecar and files in both packages."""
    victim = 5
    good = {}

    def make(seed_dir):
        _plain_volume(seed_dir)
        with jax_volume.Volume(seed_dir / "1", 1).load() as v:
            good["rec"], off = v.read_record(victim)
            good["sha"] = hashlib.sha256(v.read_needle(victim).data) \
                .hexdigest()
        _flip_byte(str(seed_dir / "1.dat"), off + 30)

    roots = _copies(tmp_path, make)
    out = {}
    for name, (mod, _s, vol_mod, _kw) in SCRUB.items():
        c0 = _counter(mod, "scrub_corrupt_total", kind="needle")
        q0 = _counter(mod, "scrub_quarantined_total")
        r0 = _counter(mod, "scrub_repaired_total", kind="needle")
        f0 = _counter(mod, "scrub_repair_failed_total", kind="needle")
        with vol_mod.Volume(roots[name] / "1", 1).load() as vol:
            with pytest.raises(Exception):
                vol.read_needle(victim)     # the read path refuses it
            res = mod.scrub_volume(
                vol, mod.RatePacer(0),
                fetch_record=(lambda key: good["rec"] if key == victim
                              else None) if fetch else None)
            if fetch:
                assert hashlib.sha256(vol.read_needle(victim).data) \
                    .hexdigest() == good["sha"]
        assert (res["corrupt"], res["repaired"], res["repair_failed"]) == \
            ((1, 1, 0) if fetch else (1, 0, 1))
        q = mod.quarantine_dir(roots[name] / "1")
        assert [p.name for p in q.iterdir()] == [f"needle-1-{victim}.rec"]
        assert (_counter(mod, "scrub_corrupt_total", kind="needle") - c0,
                _counter(mod, "scrub_quarantined_total") - q0,
                _counter(mod, "scrub_repaired_total", kind="needle") - r0,
                _counter(mod, "scrub_repair_failed_total", kind="needle")
                - f0) == ((1, 1, 1, 0) if fetch else (1, 1, 0, 1))
        files = {p.relative_to(roots[name]).as_posix(): p.read_bytes()
                 for p in sorted(roots[name].rglob("*"))
                 if p.is_file() and p.suffix != ".scrub"}
        out[name] = (_masked(res, roots[name]), _sidecar(roots[name] / "1"),
                     files)
    assert out["port"] == out["jax"]


def test_scrub_volume_skips_a_needle_deleted_mid_scrub(tmp_path):
    """A needle deleted between the snapshot and its read is skipped,
    not counted."""
    _plain_volume(tmp_path)
    with port_volume.Volume(tmp_path / "1", 1).load() as vol:
        real = vol.read_record

        def read_record(key):
            if key == 3:
                vol.delete_needle(3)
            return real(key)

        vol.read_record = read_record
        res = scrubber.scrub_volume(vol)
    assert res["checked"] == 11 and res["corrupt"] == 0


# -- EC shard scrub ---------------------------------------------------------


def _sealed(seed_dir):
    jax_volume.generate_synthetic_volume(seed_dir / "9", 9, n_needles=80,
                                         avg_size=280, seed=5).close()
    jax_encode_volume(seed_dir / "9", JaxScheme(**GEOMETRY))


def _shards(base) -> dict:
    return {i: ec_files.shard_path(base, i).read_bytes()
            for i in ec_files.present_shards(base, 14)}


def test_scrub_ec_baseline_and_repair_equal_jax(tmp_path, codec):
    """First scrub: parity proven, baseline written. Then a byte flipped
    in data shard 3 and parity shard 12: both quarantined and rebuilt
    to the sealed bytes. Both packages alike at every step."""
    roots = _copies(tmp_path, _sealed)
    sealed = _shards(tmp_path / "seed" / "9")
    out = {}
    for name, (mod, scheme, _v, kw) in SCRUB.items():
        base = roots[name] / "9"
        native = rs_native.apply_gf_matrix.calls
        first = mod.scrub_ec(base, scheme, mod.RatePacer(0), **kw)
        if name == "port":
            # the host codec below DEVICE_MIN_S, else the plain versions
            assert (rs_native.apply_gf_matrix.calls > native) == \
                (codec == "host")
        assert first["baseline"] is True and first["corrupt"] == 0
        baseline = _sidecar(base)
        assert baseline["shard_sha256"] == {
            str(i): hashlib.sha256(b).hexdigest() for i, b in sealed.items()}
        for sid in (3, 12):
            _flip_byte(ec_files.shard_path(base, sid), 1000 + sid)
        c0 = _counter(mod, "scrub_corrupt_total", kind="ec")
        r0 = _counter(mod, "scrub_repaired_total", kind="ec")
        second = mod.scrub_ec(base, scheme, mod.RatePacer(0), **kw)
        assert (second["corrupt"], second["repaired"],
                second["repair_failed"]) == (2, 2, 0)
        assert (_counter(mod, "scrub_corrupt_total", kind="ec") - c0,
                _counter(mod, "scrub_repaired_total", kind="ec") - r0) \
            == (2, 2)
        assert _shards(base) == sealed
        q = mod.quarantine_dir(base)
        assert sorted(p.name for p in q.iterdir()) == ["9.ec03", "9.ec12"]
        out[name] = (first, baseline, _masked(second, roots[name]),
                     _sidecar(base),
                     {p.name: p.read_bytes() for p in q.iterdir()})
    assert out["port"] == out["jax"]


def test_scrub_ec_without_repair_only_quarantines(tmp_path):
    roots = _copies(tmp_path, _sealed)
    out = {}
    for name, (mod, scheme, _v, kw) in SCRUB.items():
        base = roots[name] / "9"
        mod.scrub_ec(base, scheme, **kw)
        _flip_byte(ec_files.shard_path(base, 6), 77)
        res = mod.scrub_ec(base, scheme, repair=False, **kw)
        assert (res["corrupt"], res["repaired"], res["repair_failed"]) == \
            (1, 0, 1)
        assert not ec_files.shard_path(base, 6).exists()
        out[name] = (_masked(res, roots[name]), _sidecar(base),
                     sorted(_shards(base)))
    assert out["port"] == out["jax"]


def test_scrub_ec_rot_before_any_baseline_is_unattributed(tmp_path):
    """Rot before a baseline exists: the parity proof fails, no baseline
    is written, corrupt is -1, in both packages."""
    roots = _copies(tmp_path, _sealed)
    out = {}
    for name, (mod, scheme, _v, kw) in SCRUB.items():
        base = roots[name] / "9"
        _flip_byte(ec_files.shard_path(base, 0), 100)
        progress = []
        res = mod.scrub_ec(base, scheme, mod.RatePacer(0),
                           progress=progress.append, **kw)
        assert res["baseline"] is False and res["corrupt"] == -1
        assert "shard_sha256" not in mod.load_state(base)
        out[name] = (res, progress)
    assert out["port"] == out["jax"]


def test_scrub_ec_progress_and_empty_volume_equal_jax(tmp_path):
    roots = _copies(tmp_path, _sealed)
    out = {}
    for name, (mod, scheme, _v, kw) in SCRUB.items():
        progress = []
        mod.scrub_ec(roots[name] / "9", scheme, progress=progress.append,
                     **kw)
        again = []
        res = mod.scrub_ec(roots[name] / "9", scheme,
                           progress=again.append, **kw)
        empty = mod.scrub_ec(roots[name] / "nothing", scheme, **kw)
        out[name] = (progress, again, res, empty)
    assert out["port"] == out["jax"]


def test_scrub_state_sidecar_is_durable_json(tmp_path):
    _sealed(tmp_path)
    scheme = SCRUB["port"][1]
    scrubber.scrub_ec(tmp_path / "9", scheme, device="cpu")
    p = scrubber.state_path(tmp_path / "9")
    doc = json.loads(p.read_bytes())
    assert "shard_sha256" in doc
    # no .tmp left behind (the store's orphan sweep would eat it)
    assert not Path(str(p) + ".tmp").exists()
    # a torn sidecar reads as no state at all
    p.write_bytes(b"{not json")
    assert scrubber.load_state(tmp_path / "9") == {}


def test_scrub_ec_refuses_the_cpu_without_cuda(tmp_path):
    """device=None means the card: without one, scrub_ec raises before
    it hashes or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    _sealed(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scrubber.scrub_ec(tmp_path / "9", SCRUB["port"][1])
    assert not scrubber.state_path(tmp_path / "9").exists()
