"""The port's CUDA kernels and host path on the card. Every test here
needs a CUDA card and skips without one: the kernels have no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Each kernel is held byte for byte against its plain PyTorch version on
the same inputs (GF(2^8) coding is exact: tolerance 0)."""

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ops import gf256, rs_cuda, rs_native, rs_torch
from seaweedfs_tpu_torch.pipeline import encode, pipe, read, repair
from seaweedfs_tpu_torch.pipeline import repair_bench
from seaweedfs_tpu_torch.pipeline.scheme import EcScheme
from seaweedfs_tpu_torch.storage import ec_files, volume
from torch_runs import dispatched, expected_runs, plan_shapes

LOST = (2, 7, 11, 13)
PRESENT = [i for i in range(14) if i not in LOST]
KERNELS = [(rs_cuda.apply_gf_matrix_transpose,
            rs_cuda.apply_gf_matrix_transpose_ref),
           (rs_cuda.apply_gf_matrix_swar, rs_cuda.apply_gf_matrix_swar_ref)]
KINDS = ["transpose", "swar"]
#: (n_in, n_out): every output-count instance with 10 inputs, other input
#: counts, and 70 inputs, whose table fits only 7 outputs per launch
SWEEP = [(10, m) for m in range(1, 9)] + [(4, 4), (6, 3), (12, 4), (70, 8)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _grouped_plans(dat_size: int) -> list:
    """The batch shapes of a seal on one card: grouped dispatch is on
    there, so each batch is at most ``[pipeline] grouped_batch_bytes``."""
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    bound = pipe.pick_grouped_dispatch(None, pipe.current().batch_bytes,
                                       device="cuda")[2]
    return plan_shapes(encode.plan_batches(dat_size, DEFAULT_SCHEME, bound))


@pytest.fixture(autouse=True)
def _host_slabs_to_the_card(monkeypatch):
    """Pin the link-bandwidth rule to the card, so that every host
    product from DEVICE_MIN_S launches a kernel whatever the probe
    would say on this machine."""
    monkeypatch.setenv("SEAWEEDFS_TORCH_HOST_DISPATCH", "device")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
@pytest.mark.parametrize("s", [65536, 65536 + 300, 65536 + 1003])
@pytest.mark.parametrize("n_in,n_out", SWEEP,
                         ids=[f"{k}to{m}" for k, m in SWEEP])
def test_kernel_matches_plain_version(kernel, s, n_in, n_out):
    _need_card()
    wrapper, plain = KERNELS[kernel]
    enc = rs_torch.Encoder(n_in, n_out, device="cuda")
    x = torch.randint(0, 256, (3, n_in, s), dtype=torch.uint8,
                      device="cuda",
                      generator=torch.Generator("cuda").manual_seed(s))
    sets = [enc.parity_coefs]
    if (n_in, n_out) == (10, 4):
        sets.append(enc.decode_matrix_rows(PRESENT, list(LOST)))
    per = rs_cuda.outputs_per_launch(n_in)
    for coefs in sets:
        n = wrapper.launches
        y = wrapper(coefs, x)
        torch.cuda.synchronize()
        assert wrapper.launches == n + -(-n_out // per)
        assert torch.equal(y, plain(coefs, x))
    assert rs_cuda.blocks_per_sm(KINDS[kernel], min(n_out, per), n_in) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
def test_queued_launch_outlives_its_table(kernel):
    """A launch queued on a side stream keeps its coefficients after the
    table cache is cleared and the default stream reuses freed memory:
    the table travels in the launch's parameters."""
    _need_card()
    wrapper, plain = KERNELS[kernel]
    coefs = rs_torch.Encoder(10, 4, device="cuda").parity_coefs
    x = torch.randint(0, 256, (1, 10, 1 << 20), dtype=torch.uint8,
                      device="cuda")
    want = plain(coefs, x)
    wrapper(coefs, x)                    # first use on the default stream
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)   # keep the next launch queued
        y = wrapper(coefs, x)
    rs_cuda._host_table.cache_clear()
    junk = [torch.full((coefs.size * 8,), 0xFF, dtype=torch.uint8,
                       device="cuda") for _ in range(64)]
    torch.cuda.synchronize()
    assert torch.equal(y, want)
    del junk


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
def test_kernel_more_outputs_than_one_launch(kernel):
    _need_card()
    wrapper, plain = KERNELS[kernel]
    coefs = gf256.build_code_matrix(4, 16)[4:]          # 12 outputs
    x = torch.randint(0, 256, (2, 4, 4096), dtype=torch.uint8,
                      device="cuda")
    n = wrapper.launches
    assert torch.equal(wrapper(coefs, x), plain(coefs, x))
    assert wrapper.launches == n + 2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 1], ids=KINDS)
def test_kernel_takes_a_view_at_an_odd_offset(kernel):
    _need_card()
    wrapper, plain = KERNELS[kernel]
    coefs = rs_torch.Encoder(10, 4, device="cuda").parity_coefs
    flat = torch.randint(0, 256, (10 * 4096 + 3,), dtype=torch.uint8,
                         device="cuda")
    x = flat[3:].view(1, 10, 4096)          # contiguous, 3 bytes in
    assert x.data_ptr() % 16
    assert torch.equal(wrapper(coefs, x), plain(coefs, x))


@pytest.mark.cuda
def test_host_results_come_back_in_order_from_pinned_buffers(monkeypatch):
    _need_card()
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 0)   # every slab to the card
    enc = rs_torch.Encoder(10, 4)                       # device=None
    assert enc.device.type == "cuda"
    cpu = rs_torch.Encoder(10, 4, device="cpu")
    pool = pipe.HostBufferPool(10 * 8192, 3, pinned=True)
    rng = np.random.default_rng(0)
    bufs, results, wants = [], [], []
    for _ in range(3):
        buf = pool.acquire()
        batch = buf.reshape(1, 10, 8192)
        batch[:] = rng.integers(0, 256, batch.shape, dtype=np.uint8)
        wants.append(cpu.encode_parity_host(batch.copy()))
        results.append(enc.encode_parity_host(batch))
        bufs.append(buf)
    for want, got, buf in zip(wants, results, bufs):
        np.testing.assert_array_equal(np.asarray(got), want)
        buf[:] = 0          # safe: the copy that read it has completed
        pool.release(buf)
    assert pool.in_flight() == 0


#: the read path's small geometry (tests/test_torch_read.py), and a
#: threshold that sends intervals of 2 KiB and more to the kernels
READ_SCHEME = EcScheme(10, 4, large_block_size=64 * 1024,
                       small_block_size=8 * 1024)
READ_LOST = (0, 5, 11, 13)


def _launches():
    return (rs_cuda.apply_gf_matrix_transpose.launches
            + rs_cuda.apply_gf_matrix_swar.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("aggregated", [False, True],
                         ids=["direct", "aggregator"])
def test_reader_on_the_card_matches_the_cpu(tmp_path, monkeypatch,
                                            aggregated):
    _need_card()
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 2048)
    base = tmp_path / "v"
    n = volume.write_synthetic_volume(base, 300_000, avg_size=3000, seed=7)
    encode.encode_volume(base, READ_SCHEME, device="cpu")
    for i in READ_LOST:
        ec_files.shard_path(base, i).unlink()
    launches0, calls0 = _launches(), rs_native.apply_gf_matrix.calls
    cpu = read.EcVolumeReader(base, READ_SCHEME, device="cpu")
    want = {k: cpu.read_record(k) for k in range(1, n + 1)}
    if aggregated:
        with repair.IntervalRepairAggregator(READ_SCHEME,
                                             device="cuda") as agg:
            card = read.EcVolumeReader(base, READ_SCHEME, aggregator=agg)
            got = {k: card.read_record(k) for k in range(1, n + 1)}
    else:
        card = read.EcVolumeReader(base, READ_SCHEME)       # device=None
        got = {k: card.read_record(k) for k in range(1, n + 1)}
    assert got == want
    assert card.intervals_repaired == cpu.intervals_repaired > 0
    assert _launches() > launches0
    assert rs_native.apply_gf_matrix.calls > calls0


@pytest.mark.cuda
def test_repair_bench_on_the_card(tmp_path):
    _need_card()
    res = repair_bench.run(duration_s=1.0, shard_len=8 << 20,
                           bulk_chunk=4 << 20, scheme=READ_SCHEME,
                           workdir=str(tmp_path))
    assert res["reads"] > 10 and res["bulk_chunks"] >= 4


@pytest.mark.cuda
def test_host_slabs_on_the_card_match_plain(monkeypatch):
    """A list of host slabs of mixed shapes: one below the small-payload
    threshold goes to the host codec, every run of adjacent slabs of one
    shape is one launch; all byte-equal to the plain versions."""
    _need_card()
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    rng = np.random.default_rng(4)
    enc = rs_torch.Encoder(10, 4)
    cpu = rs_torch.Encoder(10, 4, device="cpu")
    shapes = [(2, 10, 65536)] * 3 + [(1, 10, 2048), (3, 10, 65536 + 300),
                                     (1, 10, 1 << 20)] + [(2, 10, 65536)] * 5
    slabs = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    n = _launches()
    outs = enc.encode_parity_host_multi(slabs)
    # runs: 3 of 64 KiB | (the 2 KiB slab to the host codec) | the ragged
    # slab | the 1 MiB slab | 5 of 64 KiB
    assert _launches() == n + 4
    for x, out in zip(slabs, outs):
        assert isinstance(out, np.ndarray) == (x.shape[-1] < 4096)
        np.testing.assert_array_equal(np.asarray(out),
                                      cpu.encode_parity_host(x))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KINDS)
def test_grouped_launch_equals_per_slab_launches_and_plain(monkeypatch,
                                                          kernel):
    """One run of 16 pinned slabs of a ragged S is ONE launch, byte-equal
    to 16 single-slab launches and to the plain version."""
    _need_card()
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", kernel)
    wrapper, plain = KERNELS[KINDS.index(kernel)]
    enc = rs_torch.Encoder(10, 4)
    gen = torch.Generator("cuda").manual_seed(16)
    slabs = [torch.randint(0, 256, (2, 10, (1 << 17) + 1003),
                           dtype=torch.uint8, device="cuda", generator=gen)
             for _ in range(16)]
    host = [t.cpu().pin_memory().numpy() for t in slabs]
    n = wrapper.launches
    outs = enc.encode_parity_host_multi(host)
    assert wrapper.launches == n + 1
    got = torch.from_numpy(np.concatenate([np.asarray(o) for o in outs]))
    singles = torch.cat([wrapper(enc.parity_coefs, t) for t in slabs])
    assert wrapper.launches == n + 17
    assert torch.equal(got, singles.cpu())
    assert torch.equal(got, plain(enc.parity_coefs, torch.cat(slabs)).cpu())


@pytest.mark.cuda
def test_encode_many_on_the_card_matches_the_cpu(monkeypatch):
    _need_card()
    from seaweedfs_tpu_torch.pipeline import batch
    monkeypatch.setattr(rs_torch, "DEVICE_MIN_S", 4096)
    scheme = EcScheme(10, 4, large_block_size=64 * 1024,
                      small_block_size=8 * 1024)
    rng = np.random.default_rng(8)
    payloads = [rng.integers(0, 256, int(rng.integers(1, 900 * 1024)),
                             dtype=np.uint8) for _ in range(9)]
    n = _launches()
    _, got = batch.encode_many(payloads, scheme, 1 << 20, keep_output=True)
    assert _launches() > n
    _, want = batch.encode_many(payloads, scheme, 1 << 20, keep_output=True,
                                device="cpu")
    for mine, ref in zip(got, want):
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_shell_encode_on_the_card_matches_the_cpu(tmp_path):
    """``ec.encode`` through the admin shell on the card (device=None):
    every shard, .ecx and .vif sha256-equal to the ``-device cpu`` run,
    and the kernel launched."""
    _need_card()
    import hashlib
    import io

    from seaweedfs_tpu_torch.shell import cli, commands
    dirs = {}
    for name in ("card", "cpu"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        # 2 small rows of 1 MiB: one (2, 10, 1 MiB) slab, above
        # DEVICE_MIN_S, so the card serves it
        volume.write_synthetic_volume(dirs[name] / "3", 16 << 20,
                                      avg_size=64 * 1024, seed=3)
    n = _launches()
    env = cli.build_env([str(dirs["card"])])
    env.out = io.StringIO()
    try:
        commands.run_command(env, "ec.encode -volumeId 3")
    finally:
        env.store.close()
    assert _launches() > n
    assert cli.main(["-dir", str(dirs["cpu"]), "-device", "cpu",
                     "-c", "ec.encode -volumeId 3"]) == 0

    def digests(d):
        return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
                for p in sorted(d.iterdir())}

    got = digests(dirs["card"])
    assert "3.ec13" in got and "3.dat" not in got
    assert got == digests(dirs["cpu"])


# -- the split over a (dp, sp) grid of cuda:0 cells -------------------------

CARD4 = ["cuda:0"] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KINDS)
def test_split_over_cuda0_cells_matches_unsplit(monkeypatch, kernel):
    """A 2 x 2 grid of cuda:0 cells: B = 5 pads to 6 and S splits in
    two; one launch per cell, parity byte-equal to the unsplit path and
    to the plain versions, the padded row sliced off."""
    _need_card()
    from seaweedfs_tpu_torch.parallel import mesh
    monkeypatch.setenv("SEAWEEDFS_TORCH_KERNEL", kernel)
    m = mesh.make_mesh(CARD4, dp=2, sp=2)
    rng = np.random.default_rng(21)
    x = rng.integers(0, 256, (5, 10, (1 << 18) + 300), dtype=np.uint8)
    enc = rs_torch.Encoder(10, 4)
    wrapper = KERNELS[KINDS.index(kernel)][0]
    n = wrapper.launches
    got = np.asarray(mesh.encode_parity_host_sharded(enc, x, m))
    assert wrapper.launches == n + 4
    assert got.shape == (5, 4, x.shape[2])
    np.testing.assert_array_equal(got, np.asarray(enc.encode_parity_host(x)))
    np.testing.assert_array_equal(
        got, rs_torch.Encoder(10, 4, device="cpu").encode_parity_host(x))


@pytest.mark.cuda
def test_dryrun_over_cuda0_cells():
    _need_card()
    from seaweedfs_tpu_torch.parallel import dryrun
    n = _launches()
    out = dryrun.run(CARD4)
    assert out["mesh"] == {"dp": 2, "sp": 2} and out["mismatches"] == 0
    assert _launches() > n


@pytest.mark.cuda
def test_one_by_one_mesh_encode_keeps_bytes_and_launches(tmp_path):
    """``-mesh 1,1`` on one card: the same shard bytes and the same
    launches as the unsplit encode; ``-mesh 2,2`` is refused."""
    _need_card()
    import hashlib

    from seaweedfs_tpu_torch.parallel import mesh
    bases = {}
    for name in ("plain", "mesh"):
        bases[name] = tmp_path / name
        volume.write_synthetic_volume(bases[name], 16 << 20,
                                      avg_size=64 * 1024, seed=3)
    n = _launches()
    encode.write_ec_files(bases["plain"])
    plain_launches = _launches() - n
    with mesh.scoped("1,1", "cuda"):
        encode.write_ec_files(bases["mesh"])
    assert _launches() - n == 2 * plain_launches > 0
    for i in range(14):
        assert hashlib.sha256(ec_files.shard_path(bases["plain"], i)
                              .read_bytes()).digest() == \
            hashlib.sha256(ec_files.shard_path(bases["mesh"], i)
                           .read_bytes()).digest()
    if torch.cuda.device_count() == 1:
        with pytest.raises(mesh.MeshConfigError, match="dp,sp"):
            with mesh.scoped("2,2", "cuda"):
                pass


# -- the [pipeline] / [mesh] / [flight] slice on the card -------------------

@pytest.fixture
def pipeline_state():
    """The [pipeline], [mesh] and [flight] state restored after the
    test."""
    import dataclasses

    from seaweedfs_tpu_torch.parallel import mesh
    from seaweedfs_tpu_torch.pipeline import flight
    saved = dataclasses.replace(pipe.current())
    yield
    for f in dataclasses.fields(saved):
        setattr(pipe.current(), f.name, getattr(saved, f.name))
    mesh.configure(enabled=False, dp=0, sp=0)
    flight.disarm()
    flight.reset()


def _digests(base):
    import hashlib
    return [hashlib.sha256(ec_files.shard_path(base, i).read_bytes())
            .hexdigest() for i in range(14)]


def _two_volumes(tmp_path, *names):
    bases = {}
    for name in names:
        bases[name] = tmp_path / name
        # 16 MiB: 2 small rows of 1 MiB blocks
        volume.write_synthetic_volume(bases[name], 16 << 20,
                                      avg_size=64 * 1024, seed=3)
    return bases


@pytest.mark.cuda
def test_copy_stream_only_under_the_lookahead():
    """A 1 x 1 mesh prepare copies on the side stream ahead of the
    kernel (no event to wait on) unless the lookahead asks for the copy
    stream; both give the unsplit parity, one launch each."""
    _need_card()
    from seaweedfs_tpu_torch.parallel import mesh
    enc = rs_torch.Encoder(10, 4)
    m = mesh.make_mesh(mesh.local_devices("cuda")[:1], dp=1, sp=1)
    x = np.random.default_rng(8).integers(0, 256, (2, 10, 1 << 20),
                                          dtype=np.uint8)
    want = np.asarray(enc.encode_parity_host(x))
    for copy_stream in (False, True):
        prep, apply = mesh.encode_step_fns(enc, m, copy_stream=copy_stream)
        placed = prep(x)
        assert (placed.arr.ready[0] is not None) == copy_stream
        n = _launches()
        got = np.asarray(apply(placed))
        assert _launches() - n == 1
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_double_buffer_mesh_encode_keeps_bytes_and_launches(
        tmp_path, pipeline_state):
    """-config with [pipeline] double_buffer and [mesh] 1 x 1: the
    prepare of each batch's copy on the copy stream runs ahead of the
    previous batch's kernel; one launch per batch, the unsplit bytes,
    and the flight recorder holds every batch of the plans."""
    _need_card()
    import io
    import json
    from contextlib import redirect_stdout

    from seaweedfs_tpu_torch.pipeline import flight
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.shell import cli
    bases = _two_volumes(tmp_path, "plain", "split")
    encode.write_ec_files(bases["plain"])
    conf = tmp_path / "c.toml"
    conf.write_text("[pipeline]\nbatch_bytes = 4194304\n"
                    "double_buffer = true\n[mesh]\nenabled = true\n"
                    "[flight]\nenabled = true\n")
    d = tmp_path / "d"
    d.mkdir()
    for ext in (".dat", ".idx"):
        (d / f"5{ext}").write_bytes(
            (bases["split"].parent / f"split{ext}").read_bytes())
    dat = (d / "5.dat").stat().st_size
    plans = list(encode.plan_batches(dat, DEFAULT_SCHEME, 4 << 20))
    trace = tmp_path / "t.json"
    out = io.StringIO()
    n = _launches()
    with redirect_stdout(out):
        rc = cli.main(["-dir", str(d), "-config", str(conf), "-c",
                       f"ec.encode -volumeId 5; pipeline.analyze; "
                       f"pipeline.dump -trace {trace}"])
    assert rc == 0, out.getvalue()
    assert _launches() - n == len(plans) == 6
    assert _digests(d / "5") == _digests(bases["plain"])
    lines = out.getvalue().splitlines()
    assert lines[1].startswith("pipeline.analyze: bottleneck: ")
    assert " batches=6 " in lines[2]
    spans = [e for e in json.loads(trace.read_text())["traceEvents"]
             if e["ph"] == "X"]
    for name in ("read", "dispatch", "d2h_sync", "write"):
        assert sorted(e["args"]["batch"] for e in spans
                      if e["name"] == name) == list(range(6)), name
    # the copies' spans carry no batch id: one per batch all the same
    assert sum(e["name"] == "h2d" for e in spans) == 6
    assert not flight.armed()         # main restored the config


@pytest.mark.cuda
def test_armed_encode_records_every_batch_of_its_plans(tmp_path,
                                                       pipeline_state):
    """An armed unsplit encode on the card: the recorder's last run holds
    one batch per plan, each with its read, dispatch, sync and write."""
    _need_card()
    from seaweedfs_tpu_torch.pipeline import flight
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    base = _two_volumes(tmp_path, "v")["v"]
    dat = (tmp_path / "v.dat").stat().st_size
    # 4 MiB batches: 3 column chunks of each 1 MiB row, every one at
    # least DEVICE_MIN_S long, so each launches the kernel
    plans = list(encode.plan_batches(dat, DEFAULT_SCHEME, 4 << 20))
    flight.configure(enabled=True)
    n = _launches()
    st = pipe.PipeStats()
    with pipe.recording_steps() as steps:
        encode.write_ec_files(base, max_batch_bytes=4 << 20, stats=st)
    # grouped dispatch: one launch per stretch of equal-shaped batches
    # inside a dispatch step
    assert dispatched(steps) == plan_shapes(plans) and len(plans) == 6
    assert _launches() - n == expected_runs(steps)
    assert st.groups == len(steps) and st.batches == len(plans)
    occ = flight.occupancy()
    assert occ["batches"] == len(plans)
    assert occ["busy_seconds"]["d2h"] > 0
    assert flight.debug_payload()["last_run"]["batches"] == len(plans)


# -- the storage engine at rest: scrub_ec's parity proof and repair ---------


def _sealed_on_the_card(tmp_path):
    """A 48 MiB volume sealed on the card: 5 small rows of 1 MiB, so
    each shard is 5 MiB, two 4 MiB chunks of the parity proof (4 MiB and
    1 MiB, both at least DEVICE_MIN_S long)."""
    base = tmp_path / "9"
    volume.write_synthetic_volume(base, 48 << 20, avg_size=1 << 20, seed=9)
    encode.encode_volume(base)
    return base


@pytest.mark.cuda
def test_scrub_ec_parity_proof_launches_once_per_chunk(tmp_path,
                                                       monkeypatch):
    """scrub_ec's baseline pass on the card: one kernel launch per 4 MiB
    chunk of the shards, each product byte-equal to the plain version's
    on the same survivors."""
    _need_card()
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.storage import scrubber
    base = _sealed_on_the_card(tmp_path)
    shard_len = ec_files.shard_path(base, 0).stat().st_size
    seen = []
    real = rs_torch.Encoder.reconstruct_batch_host

    def spy(self, shards, present, wanted=None):
        out = real(self, shards, present, wanted)
        seen.append((shards.copy(), list(present), list(wanted),
                     np.array(out)))
        return out

    monkeypatch.setattr(rs_torch.Encoder, "reconstruct_batch_host", spy)
    n = _launches()
    res = scrubber.scrub_ec(base, DEFAULT_SCHEME)
    assert res["baseline"] and res["corrupt"] == 0
    want = -(-shard_len // scrubber.EC_CHUNK_BYTES)
    assert want == 2
    assert _launches() - n == len(seen) == want
    # the plain version through the unpatched method: the spy would
    # append to ``seen`` while it is iterated
    cpu = rs_torch.Encoder(10, 4, device="cpu")
    for shards, present, wanted, out in list(seen):
        assert present == list(range(10)) and wanted == [10, 11, 12, 13]
        assert out.shape == (1, 4, shards.shape[-1])
        np.testing.assert_array_equal(
            out, np.asarray(real(cpu, shards, present, wanted)))


@pytest.mark.cuda
def test_scrub_ec_repairs_rotten_shards_on_the_card(tmp_path):
    """A byte flipped in data shard 3 and in parity shard 12 after the
    baseline: both quarantined and rebuilt on the card to their sealed
    bytes."""
    _need_card()
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.storage import scrubber
    base = _sealed_on_the_card(tmp_path)
    scrubber.scrub_ec(base, DEFAULT_SCHEME)
    sealed = {i: ec_files.shard_path(base, i).read_bytes() for i in (3, 12)}
    for sid in sealed:
        p = ec_files.shard_path(base, sid)
        buf = bytearray(sealed[sid])
        buf[len(buf) // 2] ^= 0xFF
        p.write_bytes(bytes(buf))
    n = _launches()
    res = scrubber.scrub_ec(base, DEFAULT_SCHEME)
    assert _launches() > n
    assert (res["corrupt"], len(res["quarantined"]), res["repaired"],
            res["repair_failed"]) == (2, 2, 2, 0)
    for sid, data in sealed.items():
        assert ec_files.shard_path(base, sid).read_bytes() == data


@pytest.fixture
def card_server(tmp_path):
    """A port volume server on the card (device=None) with no master,
    holding a 48 MiB volume of 1 MiB needles as volume 9; its gRPC
    stub."""
    _need_card()
    import grpc
    from seaweedfs_tpu_torch import pb
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           _grpc_port,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.storage.store import Store
    volume.write_synthetic_volume(tmp_path / "9", 48 << 20,
                                  avg_size=1 << 20, seed=9)
    store = Store([tmp_path])
    store.load_existing()
    vs = VolumeServer(store, port=free_port_pair()).start()
    ch = grpc.insecure_channel(f"127.0.0.1:{_grpc_port(vs.port)}")
    yield vs, pb.volume_stub(ch)
    ch.close()
    vs.stop()


@pytest.mark.cuda
def test_volume_server_generate_launches_once_per_batch(card_server):
    """``VolumeEcShardsGenerate`` on the card: one transpose launch per
    run of the seal's (grouped) batches, and parity equal to ``rs_ref``
    on sampled rows."""
    from seaweedfs_tpu_torch.ops import rs_ref
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    vs, stub = card_server
    base = vs.store.get_volume(9).base
    dat = volume.dat_path(base)
    dat_size = dat.stat().st_size
    plans = _grouped_plans(dat_size)
    n = rs_cuda.apply_gf_matrix_transpose.launches
    with pipe.recording_steps() as steps:
        stub.VolumeEcShardsGenerate(vpb.VolumeEcShardsGenerateRequest(
            volume_id=9))
    assert dispatched(steps) == plans
    assert rs_cuda.apply_gf_matrix_transpose.launches - n == \
        expected_runs(steps)
    assert dat.exists()
    ref = rs_ref.ReferenceEncoder(10, 4)
    size = ec_files.shard_path(base, 0).stat().st_size
    rng = np.random.default_rng(1)
    for off in rng.integers(0, size - 4096, 4):
        rows = [np.frombuffer(ec_files.shard_path(base, i).read_bytes()
                              [off:off + 4096], dtype=np.uint8)
                for i in range(14)]
        assert np.array_equal(ref.encode_parity(np.stack(rows[:10])),
                              np.stack(rows[10:]))


@pytest.mark.cuda
def test_volume_server_get_repairs_on_the_card(card_server):
    """An HTTP GET of a needle whose shards are lost rebuilds its
    intervals on the card and returns the needle's bytes: needle 1
    starts the volume, so its first interval (at least half a MiB, over
    DEVICE_MIN_S) lies in lost shard 0."""
    import urllib.request
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.storage.types import FileId
    vs, stub = card_server
    vol = vs.store.get_volume(9)
    want = {k: vol.read_needle(k) for k in (1, 2)}
    stub.VolumeEcShardsGenerate(vpb.VolumeEcShardsGenerateRequest(
        volume_id=9))
    stub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
        volume_id=9, shard_ids=list(range(14))))
    stub.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=9))
    stub.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
        volume_id=9, shard_ids=[0, 1]))
    for k, n in want.items():
        before = _launches()
        url = f"http://{vs.url}/{FileId(9, k, n.cookie)}"
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.read() == n.data
        if k == 1:
            assert _launches() > before


@pytest.mark.cuda
def test_hot_degraded_needle_launches_only_on_the_first_read(card_server):
    """The post-decode cache: a needle whose first interval lies in lost
    shard 0 is repaired on the card by its first GET; the second GET is
    served from the server's cache with no launch, byte-equal; after the
    volume is invalidated the next GET repairs again."""
    import urllib.request
    from seaweedfs_tpu_torch.cache import invalidation
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.storage.types import FileId
    vs, stub = card_server
    n = vs.store.get_volume(9).read_needle(1)
    stub.VolumeEcShardsGenerate(vpb.VolumeEcShardsGenerateRequest(
        volume_id=9))
    stub.VolumeEcShardsMount(vpb.VolumeEcShardsMountRequest(
        volume_id=9, shard_ids=list(range(14))))
    stub.VolumeDelete(vpb.VolumeDeleteRequest(volume_id=9))
    stub.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
        volume_id=9, shard_ids=[0, 5, 11, 13]))
    url = f"http://{vs.url}/{FileId(9, 1, n.cookie)}"
    counts = []
    for _ in range(2):
        before = _launches()
        with urllib.request.urlopen(url, timeout=60) as r:
            assert r.read() == n.data
        counts.append(_launches() - before)
    assert counts[0] > 0 and counts[1] == 0
    assert vs.chunk_cache.per_volume_counts()[9] == {"hits": 1,
                                                     "misses": 1}
    invalidation.volume_invalidated(9, reason="test")
    before = _launches()
    with urllib.request.urlopen(url, timeout=60) as r:
        assert r.read() == n.data
    assert _launches() > before


@pytest.mark.cuda
def test_master_driven_ec_lifecycle_on_the_card(tmp_path):
    """A port master and two port servers on the card: the cluster
    shell's ``ec.encode`` launches once per run of its grouped batches,
    ``operation.download``
    with shards 0, 5, 11 and 13 gone reconstructs on the card (the
    server fetching the shards it lacks through ``ec_shard_peers``),
    ``ec.rebuild`` restores the lost shards byte-equal and ``ec.decode``
    the original ``.dat``."""
    _need_card()
    import hashlib
    import io

    from seaweedfs_tpu_torch.cluster import operation
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)
    from seaweedfs_tpu_torch.storage.store import Store

    lost = [0, 5, 11, 13]
    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5).start()
    servers = []
    for name in "ab":
        d = tmp_path / name
        d.mkdir()
        servers.append(VolumeServer(
            Store([d]), port=free_port_pair(), master_url=ms.url,
            rack="r0", pulse_seconds=0.5).start())
        servers[-1].heartbeat_now()
    mc = MasterClient(ms.url)
    env = ClusterEnv(master_url=ms.url, out=io.StringIO())

    def settle():
        for vs in servers:
            vs.heartbeat_now()

    try:
        rng = np.random.default_rng(10)
        blobs = [rng.integers(0, 256, 700_000, dtype=np.uint8).tobytes()
                 for _ in range(40)]
        fids = operation.submit(mc, blobs)
        vid = int(fids[0].split(",")[0])
        keep = [(f, b) for f, b in zip(fids, blobs)
                if int(f.split(",")[0]) == vid]
        owner = next(vs for vs in servers if vs.store.has_volume(vid))
        vol = owner.store.get_volume(vid)
        vol.sync()
        dat = volume.dat_path(vol.base)
        dat_size = dat.stat().st_size
        dat_sha = hashlib.sha256(dat.read_bytes()).hexdigest()
        plans = _grouped_plans(dat_size)
        n = rs_cuda.apply_gf_matrix_transpose.launches
        with pipe.recording_steps() as steps:
            run_cluster_command(env, f"ec.encode -volumeId {vid}")
        assert dispatched(steps) == plans
        assert rs_cuda.apply_gf_matrix_transpose.launches - n == \
            expected_runs(steps)
        settle()
        for vs in servers:
            m = vs.store.ec_mounts[("", vid)]
            gone = sorted(set(m.shard_ids) & set(lost))
            stub_env = ClusterEnv(master_url=ms.url)
            stub_env.volume(vs.url).VolumeEcShardsDelete(
                vpb.VolumeEcShardsDeleteRequest(volume_id=vid,
                                                shard_ids=gone))
            stub_env.close()
        settle()
        mc.invalidate()
        before = _launches()
        for fid, blob in keep:
            assert operation.download(mc, fid) == blob
        assert _launches() > before
        n = rs_cuda.apply_gf_matrix_transpose.launches
        run_cluster_command(env, "ec.rebuild")
        assert rs_cuda.apply_gf_matrix_transpose.launches > n
        assert f"rebuilt {lost}" in env.out.getvalue()
        settle()
        assert sorted(ms.topology.lookup_ec_volume(vid)) == list(range(14))
        run_cluster_command(env, f"ec.decode -volumeId {vid}")
        settle()
        back = [vs for vs in servers if vs.store.has_volume(vid)]
        assert len(back) == 1
        got = volume.dat_path(back[0].store.get_volume(vid).base)
        assert hashlib.sha256(got.read_bytes()).hexdigest() == dat_sha
    finally:
        env.close()
        mc.close()
        for vs in servers:
            vs.stop()
        ms.stop()


@pytest.mark.cuda
def test_job_worker_ec_encode_launches_the_transpose_kernel(tmp_path):
    """``ec.encode -distributed`` through a port master to one port
    server on the card: the job worker's seal launches the transpose
    kernel once per run (grouped) on its own thread, and the parity equals
    ``rs_ref``'s."""
    _need_card()
    import io

    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.ops import rs_ref
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)
    from seaweedfs_tpu_torch.storage.store import Store

    d = tmp_path / "a"
    d.mkdir()
    volume.generate_synthetic_volume(d / "jobs_3", 3, 24, avg_size=400_000,
                                     seed=3).close()
    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5).start()
    st = Store([d])
    st.load_existing()
    vs = VolumeServer(st, port=free_port_pair(), master_url=ms.url,
                      pulse_seconds=0.5, job_poll_seconds=0.1).start()
    vs.heartbeat_now()
    env = ClusterEnv(master_url=ms.url, out=io.StringIO())
    try:
        base = vs.store.get_volume(3, "jobs").base
        dat_size = volume.dat_path(base).stat().st_size
        plans = _grouped_plans(dat_size)
        n = rs_cuda.apply_gf_matrix_transpose.launches
        run_cluster_command(env, "ec.encode -distributed -collection jobs")
        [task] = vs.job_worker.finished
        runs = expected_runs(task["steps"])
        assert dispatched(task["steps"]) == plans
        assert rs_cuda.apply_gf_matrix_transpose.launches - n == runs
        assert task["ok"] and task["launches"] == {"transpose": runs}
        k = DEFAULT_SCHEME.data_shards
        shards = [np.fromfile(ec_files.shard_path(base, i), dtype=np.uint8)
                  for i in range(DEFAULT_SCHEME.total_shards)]
        ref = rs_ref.ReferenceEncoder(k, DEFAULT_SCHEME.parity_shards)
        assert np.array_equal(ref.encode_parity(np.stack(shards[:k])),
                              np.stack(shards[k:]))
    finally:
        env.close()
        vs.stop()
        ms.stop()


@pytest.mark.cuda
def test_policy_seals_a_full_volume_on_the_card_with_no_command(tmp_path):
    """A port master with the policy armed (1 MB size limit) and one
    port server on ``cuda:0`` holding an unread 4 MiB volume, past 90% of
    the limit:
    the master submits ``ec_encode`` on its own, the seal launches the
    transpose kernel once per run (grouped), its parity equals ``rs_ref``'s,
    and
    a degraded read after the source and shards 0, 5, 11 and 13 are
    dropped is counted once as an EC decode at the master."""
    _need_card()
    import time

    from seaweedfs_tpu_torch.cluster import operation
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
    from seaweedfs_tpu_torch.ops import rs_ref
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.pipeline.scheme import DEFAULT_SCHEME
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.storage.types import FileId

    d = tmp_path / "a"
    d.mkdir()
    # 1 MiB needles: needle 1 starts the volume, so its first interval
    # (over DEVICE_MIN_S) lies in lost shard 0 and repairs on the card
    volume.write_synthetic_volume(d / "4", 4 << 20, avg_size=1 << 20,
                                  seed=4)
    v = volume.Volume(d / "4", 4).load()
    n = v.read_needle(1)
    fid, want = str(FileId(4, n.id, n.cookie)), n.data
    v.close()
    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5,
                      volume_size_limit_mb=1)
    ms.policy.configure({"policy": True, "policy_interval_seconds": 0.5,
                         "cooldown_seconds": 600.0})
    ms.start()
    st = Store([d])
    st.load_existing()
    base = st.get_volume(4, "").base
    dat_size = volume.dat_path(base).stat().st_size
    plans = _grouped_plans(dat_size)
    n0 = rs_cuda.apply_gf_matrix_transpose.launches
    vs = VolumeServer(st, port=free_port_pair(), master_url=ms.url,
                      pulse_seconds=0.5, job_poll_seconds=0.1).start()
    mc = None
    try:
        vs.heartbeat_now()
        deadline = time.time() + 60
        while time.time() < deadline and not vs.job_worker.finished:
            time.sleep(0.05)
        [task] = vs.job_worker.finished
        [job] = ms.jobs.to_map()["jobs"]
        assert job["submittedBy"] == "policy" and job["kind"] == "ec_encode"
        runs = expected_runs(task["steps"])
        assert dispatched(task["steps"]) == plans
        assert task["ok"] and task["launches"] == {"transpose": runs}
        assert rs_cuda.apply_gf_matrix_transpose.launches - n0 == runs
        k = DEFAULT_SCHEME.data_shards
        shards = [np.fromfile(ec_files.shard_path(base, i), dtype=np.uint8)
                  for i in range(DEFAULT_SCHEME.total_shards)]
        ref = rs_ref.ReferenceEncoder(k, DEFAULT_SCHEME.parity_shards)
        assert np.array_equal(ref.encode_parity(np.stack(shards[:k])),
                              np.stack(shards[k:]))
        vs.servicer.VolumeDelete(vpb.VolumeDeleteRequest(
            volume_id=4, collection=""), None)
        vs.servicer.VolumeEcShardsDelete(vpb.VolumeEcShardsDeleteRequest(
            volume_id=4, collection="", shard_ids=[0, 5, 11, 13]), None)
        vs.heartbeat_now()
        mc = MasterClient(ms.url)
        n1 = rs_cuda.apply_gf_matrix_transpose.launches
        assert operation.download(mc, fid) == want
        assert rs_cuda.apply_gf_matrix_transpose.launches > n1
        vs.heartbeat_now()
        row = ms.topology.telemetry.node_volumes(vs.url)[4]
        assert row["ec_decodes"] == 1 and row["read_ops"] == 1
    finally:
        if mc is not None:
            mc.close()
        vs.stop()
        ms.stop()


@pytest.mark.cuda
def test_checkpoint_of_cuda_tensors_round_trips_bit_equal(tmp_path):
    """A tree of float16 and bfloat16 tensors on the card, sharded over
    a 2 x 2 grid of four ``cuda:0`` cells and replicated, saved through
    a port S3 gateway (master, volume server on the card, filer) and
    restored onto the same grid: every block ``torch.equal`` on the card
    to what was saved, staged through pinned slabs, with no launch."""
    _need_card()
    from seaweedfs_tpu_torch.ckpt import (CheckpointStore, NamedSharding,
                                          PartitionSpec, device_put)
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.gateway.s3 import S3Gateway
    from seaweedfs_tpu_torch.parallel.mesh import Mesh
    from seaweedfs_tpu_torch.storage.store import Store

    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5).start()
    vs = VolumeServer(Store([tmp_path]), port=free_port_pair(),
                      master_url=ms.url, pulse_seconds=0.5).start()
    vs.heartbeat_now()
    filer = FilerServer(Filer(), port=free_port_pair(),
                        master_url=ms.url).start()
    gw = S3Gateway(filer.url, port=free_port_pair()).start()
    try:
        mesh = Mesh([torch.device("cuda", 0)] * 4, 2, 2)
        g = torch.Generator("cuda").manual_seed(3)
        w = torch.randn((512, 256), generator=g, device="cuda").half()
        tree = {"w": device_put(w, NamedSharding(
                    mesh, PartitionSpec("dp", "sp"))),
                "n": device_put(torch.randn(256, generator=g,
                                            device="cuda").bfloat16(),
                                NamedSharding(mesh, PartitionSpec()))}
        st = CheckpointStore(gw.url)
        man = st.save("card", tree)
        assert {p.name: p.dtype for p in man.params} == {
            "n": "bfloat16", "w": "float16"}
        n = rs_cuda.apply_gf_matrix_transpose.launches
        out = st.restore("card", mesh=mesh, template=tree)
        assert rs_cuda.apply_gf_matrix_transpose.launches == n
        for k in tree:
            assert len(out[k].blocks) == 4
            for a, b in zip(tree[k].blocks, out[k].blocks):
                assert b.data.device == torch.device("cuda", 0)
                assert (a.start, a.stop) == (b.start, b.stop)
                assert torch.equal(a.data, b.data)
        assert torch.equal(out["w"].to_tensor(), w)
    finally:
        for obj in (gw, filer, vs, ms):
            obj.stop()


@pytest.mark.cuda
def test_traced_encode_span_covers_the_compute_series(tmp_path):
    """A traced ``encode_volume`` on ``cuda:0`` has an ``ec.encode`` span
    at least as long as the sum of its run's ``pipe.compute`` series,
    which counts one observation per batch and waits on the card's
    events (dispatch share plus the sync wait)."""
    _need_card()
    from seaweedfs_tpu_torch.util import tracing
    base = tmp_path / "v"
    volume.write_synthetic_volume(base, 64 * 1024 * 1024,
                                  avg_size=64 * 1024, seed=5)
    h = tracing.METRICS.histogram("request_stage_seconds",
                                  stage="pipe.compute")
    n0, s0 = h.n, h.total
    st = pipe.PipeStats()
    rs_cuda.apply_gf_matrix_transpose.launches = 0
    with tracing.start_trace("unit.seal.cuda"), \
            pipe.recording_steps() as steps:
        encode.encode_volume(base, device="cuda:0", stats=st)
    assert dispatched(steps) == _grouped_plans(
        (tmp_path / "v.dat").stat().st_size)
    assert rs_cuda.apply_gf_matrix_transpose.launches == \
        expected_runs(steps)
    assert st.groups == len(steps) and st.batches >= 1
    assert h.n - n0 == st.batches
    t = tracing.recent_traces()[-1]
    sp, = [s for s in t["spans"] if s["name"] == "ec.encode"]
    assert sp["bytes"] == (tmp_path / "v.dat").stat().st_size
    assert sp["duration_seconds"] >= h.total - s0 > 0


def _http_json(url: str) -> dict:
    import json
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _free_port_block(offsets=(0, 100, 200)) -> int:
    """A base port whose ``base + offset`` ports and their ``+10000``
    gRPC twins are all free (the launcher's layout)."""
    import socket
    for _ in range(200):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + max(offsets) + 10000 > 65535:
            continue
        try:
            for q in [base + o + t for o in offsets for t in (0, 10000)]:
                with socket.socket() as s2:
                    s2.bind(("127.0.0.1", q))
            return base
        except OSError:
            continue
    raise RuntimeError("no free port block")


@pytest.mark.cuda
def test_server_and_cluster_run_on_the_card_by_default(tmp_path):
    """``python -m seaweedfs_tpu_torch server -filer`` and a
    ``LocalCluster`` with no device flag: both trees come up with their
    volume servers on the card (a ``cuda`` child exits 1 without one),
    the server's ``ec.encode`` runs in its own process (its
    ``/debug/vars`` pipeline ring holds the seal and its batches), and
    SIGTERM ends both with exit 0."""
    _need_card()
    import io
    import os
    import signal
    import subprocess
    import sys
    import time
    from pathlib import Path

    from seaweedfs_tpu_torch.cluster import operation
    from seaweedfs_tpu_torch.cluster.volume_server import free_port_pair
    from seaweedfs_tpu_torch.cluster.wdclient import MasterClient
    from seaweedfs_tpu_torch.cluster_launcher import LocalCluster
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)

    repo = Path(__file__).resolve().parent.parent
    mport, vport, fport = (free_port_pair() for _ in range(3))
    (tmp_path / "s").mkdir()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch", "server",
         "-dir", str(tmp_path / "s"), "-filer", "-pulseSeconds", "0.5",
         "-master.port", str(mport), "-volume.port", str(vport),
         "-filer.port", str(fport)],
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    base = _free_port_block()
    cluster = LocalCluster(tmp_path / "c", volumes=1, filer=True,
                           port_base=base, pulse_seconds=0.5)
    try:
        cluster.start()
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            try:
                _http_json(f"http://127.0.0.1:{vport}/status")
                _http_json(f"http://127.0.0.1:{mport}/cluster/status")
                break
            except OSError:
                assert time.time() < deadline, "server did not come up"
                time.sleep(0.2)
        cluster.wait_ready(timeout=120)
        mc = MasterClient(f"127.0.0.1:{mport}")
        env = ClusterEnv(master_url=f"127.0.0.1:{mport}", out=io.StringIO())
        try:
            rng = np.random.default_rng(16)
            blobs = [rng.bytes(600_000) for _ in range(16)]
            fids = operation.submit(mc, blobs)
            vid = int(fids[0].split(",")[0])
            time.sleep(1.1)
            run_cluster_command(env, f"ec.encode -volumeId {vid}")
            ring = _http_json(f"http://127.0.0.1:{vport}/debug/vars")[
                "pipeline"]["recent"]
            assert ring and ring[-1]["batches"] >= 1
            mc.invalidate()
            for fid, blob in zip(fids, blobs):
                if int(fid.split(",")[0]) == vid:
                    assert operation.download(mc, fid) == blob
        finally:
            env.close()
            mc.close()
    finally:
        cluster.stop()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    assert rc == 0


@pytest.mark.cuda
def test_degraded_filer_sync_read_launches_the_transpose_kernel(tmp_path):
    """A filer on a sealed collection with shards 0, 5, 11 and 13 lost,
    and ``filer.sync`` to a second filer: the bootstrap's copies are
    degraded reads that the volume servers reconstruct on the card, and
    every file arrives byte-equal."""
    _need_card()
    import io

    from seaweedfs_tpu_torch.cluster.filer_client import FilerClient
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.replication.filer_sync import FilerSync
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)
    from seaweedfs_tpu_torch.storage.store import Store

    lost = [0, 5, 11, 13]
    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5).start()
    servers = []
    for name in "ab":
        d = tmp_path / name
        d.mkdir()
        servers.append(VolumeServer(
            Store([d]), port=free_port_pair(), master_url=ms.url,
            rack="r0", pulse_seconds=0.5).start())
        servers[-1].heartbeat_now()
    fa = FilerServer(Filer(), port=free_port_pair(),
                     master_url=ms.url).start()
    fb = FilerServer(Filer(), port=free_port_pair(),
                     master_url=ms.url).start()
    ca, cb = FilerClient(fa.url), FilerClient(fb.url)
    env = ClusterEnv(master_url=ms.url, out=io.StringIO())
    sync = None
    try:
        rng = np.random.default_rng(17)
        files = {f"/sync/f{i}.bin": rng.bytes(int(rng.integers(
            1 << 20, 3 << 20))) for i in range(6)}
        vid = ms.grow_volume("sync")
        for vs in servers:
            vs.heartbeat_now()
        for p, data in files.items():
            ca.put_data(p, data, query="collection=sync")
        for vs in servers:
            vs.heartbeat_now()
        run_cluster_command(env, f"ec.encode -volumeId {vid} "
                                 f"-collection sync")
        for vs in servers:
            vs.heartbeat_now()
        for vs in servers:
            m = vs.store.ec_mounts[("sync", vid)]
            gone = sorted(set(m.shard_ids) & set(lost))
            env.volume(vs.url).VolumeEcShardsDelete(
                vpb.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection="sync", shard_ids=gone))
            vs.chunk_cache.clear()
            vs.heartbeat_now()
        import time
        time.sleep(1.1)   # the servers' shard-location caches expire
        from seaweedfs_tpu_torch import cache
        cache.global_chunk_cache().clear()
        before = rs_cuda.apply_gf_matrix_transpose.launches
        sync = FilerSync(fa.url, fb.url).start()
        assert sync.wait_converged(lambda: all(
            fb.filer.find_entry(p) is not None for p in files),
            timeout=120)
        for p, data in files.items():
            assert cb.get_data(p) == data
        assert rs_cuda.apply_gf_matrix_transpose.launches > before
    finally:
        if sync is not None:
            sync.stop()
        env.close()
        ca.close()
        cb.close()
        fb.stop()
        fa.stop()
        for vs in servers:
            vs.stop()
        ms.stop()


@pytest.mark.cuda
def test_bufcheck_on_a_pinned_pool_on_the_card(tmp_path, monkeypatch):
    """The buffer checker over the card's page-locked pool: an armed
    ``encode_volume`` on the card tags, poisons and (in protect mode)
    closes its pinned buffers with no refusal and no violation, and its
    shards equal the disarmed seal's; a pinned buffer released while a
    queued positioned write still views it raises DanglingViewError."""
    _need_card()
    import threading

    from seaweedfs_tpu_torch.pipeline import writeback
    from seaweedfs_tpu_torch.util import bufcheck
    base = tmp_path / "v"
    volume.write_synthetic_volume(base, 64 << 20, avg_size=65536)
    encode.encode_volume(base, device="cuda")
    want = [ec_files.shard_path(base, i).read_bytes() for i in range(14)]
    was = (bufcheck.enabled(), bufcheck.protect_mode())
    bufcheck.install(protect=True)
    bufcheck.reset()
    try:
        n = rs_cuda.apply_gf_matrix_transpose.launches
        encode.encode_volume(base, max_batch_bytes=16 << 20,
                             device="cuda")
        assert rs_cuda.apply_gf_matrix_transpose.launches > n
        assert [ec_files.shard_path(base, i).read_bytes()
                for i in range(14)] == want
        st = bufcheck.stats()
        assert st["closed_pinned"] > 0 and st["refused"] == 0
        assert st["violations"] == 0

        bufcheck.install(protect=False)
        pool = pipe.HostBufferPool(1 << 20, 1, pinned=True)
        started, unblock = threading.Event(), threading.Event()
        real = writeback.pwrite_rows

        def parked(fd, offset, rows):
            started.set()
            assert unblock.wait(5)
            return real(fd, offset, rows)
        monkeypatch.setattr(writeback, "pwrite_rows", parked)
        threads = pipe.current().writer_threads
        pipe.configure(writer_threads=1)
        try:
            wp = writeback.WriterPool()
        finally:
            pipe.configure(writer_threads=threads)
        path = str(tmp_path / "shard.dat")
        wp.open_file(path)
        buf = pool.acquire()
        buf[:] = 3
        wp.submit(path, 0, [buf[:4096]])
        assert started.wait(5)
        pool.release(buf)
        unblock.set()
        with pytest.raises(writeback.WriterError) as ei:
            wp.close()
        assert isinstance(ei.value.__cause__, bufcheck.DanglingViewError)
    finally:
        bufcheck.uninstall()
        bufcheck.reset()
        if was[0]:
            bufcheck.install(protect=was[1])


@pytest.mark.cuda
def test_mount_read_of_a_sealed_volume_launches_the_transpose_kernel(
        tmp_path):
    """Files written through ``WFS``, their volume sealed by the cluster
    shell's ``ec.encode`` and shards 0, 5, 11 and 13 lost: a fresh
    ``WFS`` reads every file byte-equal in 128 KiB reads, and the
    volume servers' repairs launch the transpose kernel."""
    _need_card()
    import io
    import time

    from seaweedfs_tpu_torch import cache
    from seaweedfs_tpu_torch.cluster.filer_server import FilerServer
    from seaweedfs_tpu_torch.cluster.master import MasterServer
    from seaweedfs_tpu_torch.cluster.volume_server import (VolumeServer,
                                                           free_port_pair)
    from seaweedfs_tpu_torch.filer import Filer
    from seaweedfs_tpu_torch.mount import WFS
    from seaweedfs_tpu_torch.pb import volume_server_pb2 as vpb
    from seaweedfs_tpu_torch.shell.cluster_commands import (
        ClusterEnv, run_cluster_command)
    from seaweedfs_tpu_torch.storage.store import Store

    lost = [0, 5, 11, 13]
    ms = MasterServer(port=free_port_pair(), pulse_seconds=0.5).start()
    servers = []
    for name in "ab":
        d = tmp_path / name
        d.mkdir()
        servers.append(VolumeServer(
            Store([d]), port=free_port_pair(), master_url=ms.url,
            rack="r0", pulse_seconds=0.5).start())
        servers[-1].heartbeat_now()
    filer = FilerServer(Filer(), port=free_port_pair(),
                        master_url=ms.url).start()
    env = ClusterEnv(master_url=ms.url, out=io.StringIO())
    try:
        rng = np.random.default_rng(19)
        files = {f"/m/f{i}.bin": rng.bytes(int(rng.integers(
            1 << 20, 5 << 20))) for i in range(4)}
        vid = ms.grow_volume("mnt")
        for vs in servers:
            vs.heartbeat_now()
        w = WFS(filer.url, ms.url, collection="mnt")
        for p, data in files.items():
            fh = w.create(p)
            w.write(fh, 0, data)
            w.release(fh)
        w.close()
        for vs in servers:
            vs.heartbeat_now()
        run_cluster_command(env, f"ec.encode -volumeId {vid} "
                                 f"-collection mnt")
        for vs in servers:
            vs.heartbeat_now()
        for vs in servers:
            m = vs.store.ec_mounts[("mnt", vid)]
            gone = sorted(set(m.shard_ids) & set(lost))
            env.volume(vs.url).VolumeEcShardsDelete(
                vpb.VolumeEcShardsDeleteRequest(
                    volume_id=vid, collection="mnt", shard_ids=gone))
            vs.chunk_cache.clear()
            vs.heartbeat_now()
        time.sleep(1.1)   # the servers' shard-location caches expire
        cache.global_chunk_cache().clear()
        before = rs_cuda.apply_gf_matrix_transpose.launches
        w = WFS(filer.url, ms.url, collection="mnt")
        try:
            for p, data in files.items():
                fh = w.open(p)
                got = b"".join(w.read(fh, off, 128 << 10)
                               for off in range(0, len(data), 128 << 10))
                w.release(fh)
                assert got == data
        finally:
            w.close()
        assert rs_cuda.apply_gf_matrix_transpose.launches > before
    finally:
        env.close()
        filer.stop()
        for vs in servers:
            vs.stop()
        ms.stop()
