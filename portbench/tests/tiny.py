"""The cells cut to a size a CPU test run holds: 128 KiB blocks (the
smallest product that still takes the kernels' plain versions, at
rs_torch.DEVICE_MIN_S), a few volumes or needles, short windows."""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SEAL = {"config": {"scheme": {"small_block_bytes": 131072},
                   "volume_bytes": 2_700_000},
        "traffic": {"pool_volumes": 3, "warmup_volumes": 2,
                    "check_share": 0.25, "tail_share": 1.0}}
READ = {"config": {"scheme": {"small_block_bytes": 131072},
                   "volume_bytes": 6_000_000,
                   "needle_avg_bytes": 262_144},
        "traffic": {"clients": 4, "warmup_reads": 8, "check_share": 0.5,
                    "check_longest": 2}}
#: Every check reads, sound or broken.
EVERYTHING = {"traffic": {"check_share": 1.0}}
SEAL_CELLS = ("seal_backlog_30mib", "seal_1gib_volumes")
READ_CELL = "degraded_read_4lost"
CELLS = SEAL_CELLS + (READ_CELL,)
#: The degraded-read cell's BENCHMARK.json entries, as a later PR adds
#: them: its mode, mix and metric readers are in the benchmark, but the
#: cell is not (its runs spread too widely on the card's host, PERF.md).
READ_ENTRIES = {
    "workloads": [{
        "name": READ_CELL, "config": "volume_1gib_rs10_4",
        "traffic": "degraded_read_16c", "chips": 1,
        "why": "16 closed-loop clients read needles on lost shards"}],
    "end_to_end": [{
        "name": "degraded_read_mibps", "unit": "MiB/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [READ_CELL]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "degraded_read_mibps",
         "workloads": [READ_CELL]}
        for name, unit, better, source, layer in (
            ("read_p95_ms.degraded", "ms", "lower", "host_clock",
             "entry point (pipeline/read.py)"),
            ("repair_batch_fill.read", "requests/batch", "higher",
             "program_counter", "repair batching (pipeline/repair.py)"),
            ("kernel_roofline.read", "%", "higher", "device_trace",
             "kernels (ops/rs_cuda.py, csrc/gf_*.cu)"),
            ("device_idle.read", "%", "lower", "device_trace",
             "device (one H100)"))]}


def root_with_read_cell(tmp: Path) -> Path:
    """A checkout root in ``tmp``: this benchmark's files (linked) and a
    BENCHMARK.json that holds the degraded-read cell too."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in READ_ENTRIES.items():
        bench[key] += entries
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "portbench").symlink_to(ROOT / "portbench")
    return tmp


def root_for(cell: str, tmp: Path) -> Path:
    return root_with_read_cell(tmp) if cell == READ_CELL else ROOT


#: A batch bound that keeps the CPU's plain kernels to a few MiB in
#: flight (the shipped 256 MiB would hold a tiny window for minutes).
BATCH_BYTES = 4 * 1024 * 1024


@contextlib.contextmanager
def small_batches():
    from seaweedfs_tpu_torch.pipeline import pipe
    cfg = pipe.current()
    saved = (cfg.batch_bytes, cfg.grouped_batch_bytes)
    pipe.configure(batch_bytes=BATCH_BYTES, grouped_batch_bytes=BATCH_BYTES)
    try:
        yield
    finally:
        pipe.configure(batch_bytes=saved[0], grouped_batch_bytes=saved[1])


def overrides(cell: str, everything: bool = False) -> dict:
    base = READ if cell.startswith("degraded") else SEAL
    out = json.loads(json.dumps(base))
    if everything:
        out["traffic"].update(EVERYTHING["traffic"])
    return out


def run_cli(cell: str, seed: int = 2 ** 31 + 7, seconds: float = 0.3,
            trace: int = 0, root: Path = ROOT) -> subprocess.CompletedProcess:
    """``python3 -m portbench`` in a fresh process on the CPU at the tiny
    size, as the card's command would run it, from the checkout ``root``;
    the child prints, after the run, the top-level names of every module
    it holds."""
    code = (
        "import sys, time, json\n"
        "t0 = time.perf_counter()\n"
        "from portbench import harness\n"
        "from seaweedfs_tpu_torch.pipeline import pipe\n"
        f"pipe.configure(batch_bytes={BATCH_BYTES}, "
        f"grouped_batch_bytes={BATCH_BYTES})\n"
        f"rc = harness.main(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], t0, "
        f"device='cpu', overrides={overrides(cell)!r}, "
        f"root=harness.Path({str(root)!r}))\n"
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0] for m in "
        "list(sys.modules)})), file=sys.stderr)\n"
        "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
