"""The cells cut to a size a CPU test run holds: 128 KiB blocks (the
smallest product that still takes the kernels' plain versions, at
rs_torch.DEVICE_MIN_S), a few volumes or needles, short windows.

The cells are read from ``BENCHMARK.json`` and grouped by their mix's
``mode``; each mode has its tiny size (:data:`TINY`). A configuration
file or a mix file may carry a ``"tiny"`` object, merged over its mode's
size (``config`` and ``traffic`` respectively): the one place a cell
says how it is cut to the CPU. So a cell is added as files and appended
``BENCHMARK.json`` entries alone, and these tests take it up."""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
#: Each mode's tiny size, {"config": ..., "traffic": ...} overrides.
TINY = {
    "seal": {"config": {"scheme": {"small_block_bytes": 131072},
                        "volume_bytes": 2_700_000},
             "traffic": {"pool_volumes": 3, "warmup_volumes": 2,
                         "check_share": 0.25, "tail_share": 1.0}},
    "read": {"config": {"scheme": {"small_block_bytes": 131072},
                        "volume_bytes": 6_000_000,
                        "needle_avg_bytes": 262_144},
             "traffic": {"clients": 4, "warmup_reads": 8,
                         "check_share": 0.5, "check_longest": 2}}}
#: Every check reads, sound or broken.
EVERYTHING = {"traffic": {"check_share": 1.0}}
READ_CELL = "degraded_read_4lost"
#: The one cell list left: the degraded-read cell's BENCHMARK.json
#: entries, as a later PR adds them. Its mode, mix and metric readers
#: are in the benchmark, but the cell is not (its runs spread too widely
#: on the card's host, PERF.md), so this is the read mode's fixture.
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


def _entry(cell: str, root: Path = ROOT) -> tuple[dict, dict]:
    """(``BENCHMARK.json`` at ``root``, the workload entry of ``cell``:
    its own, else the read mode's fixture)."""
    bench = harness.load_benchmark(root)
    for w in bench["workloads"] + READ_ENTRIES["workloads"]:
        if w["name"] == cell:
            return bench, w
    raise KeyError(f"no workload {cell!r}")


def cells(mode: str, root: Path = ROOT) -> tuple:
    """The cells of ``BENCHMARK.json`` at ``root`` whose mix has ``mode``,
    and the read mode's fixture where it is not among them."""
    bench = harness.load_benchmark(root)
    names = [w["name"] for w in bench["workloads"]]
    entries = bench["workloads"] + [w for w in READ_ENTRIES["workloads"]
                                    if w["name"] not in names]
    return tuple(w["name"] for w in entries if harness.load_traffic(
        w["traffic"], root)["mode"] == mode)


SEAL_CELLS = cells("seal")
READ_CELLS = cells("read")
CELLS = SEAL_CELLS + READ_CELLS


def root_with_read_cell(tmp: Path) -> Path:
    """A checkout root in ``tmp``: this benchmark's files (linked) and a
    BENCHMARK.json that holds the degraded-read cell's entries too, those
    it does not hold already."""
    bench = harness.load_benchmark(ROOT)
    for key, entries in READ_ENTRIES.items():
        have = {e["name"] for e in bench[key]}
        bench[key] += [e for e in entries if e["name"] not in have]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp / "portbench").symlink_to(ROOT / "portbench")
    return tmp


def root_for(cell: str, tmp: Path) -> Path:
    """ROOT where its BENCHMARK.json holds ``cell``, else a root in
    ``tmp`` that holds the read mode's fixture too."""
    names = {w["name"] for w in harness.load_benchmark(ROOT)["workloads"]}
    return ROOT if cell in names else root_with_read_cell(tmp)


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


def overrides(cell: str, everything: bool = False,
              root: Path = ROOT) -> dict:
    """The CPU size of ``cell`` (of ``BENCHMARK.json`` at ``root``): its
    mode's :data:`TINY`, with the configuration's and the mix's ``tiny``
    objects merged over it; ``everything`` checks every answer."""
    bench, w = _entry(cell, root)
    mix = harness.load_traffic(w["traffic"], root)
    config = harness.load_config(bench, w["config"], root)
    out = harness._merge(TINY[mix["mode"]], {
        "config": config.get("tiny", {}), "traffic": mix.get("tiny", {})})
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
        f"device='cpu', overrides={overrides(cell, root=root)!r}, "
        f"root=harness.Path({str(root)!r}))\n"
        "print('MODULES ' + json.dumps(sorted({m.split('.')[0] for m in "
        "list(sys.modules)})), file=sys.stderr)\n"
        "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
