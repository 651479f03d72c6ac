"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything a cell is made of is found by name: the workload entry in
``BENCHMARK.json`` names its configuration (``configs[].file``) and its
traffic mix (``traffic/<name>.json``); the mix names the mode that drives
it (``modes/<mode>.py``, a ``run(cell)`` returning an :class:`Outcome`);
each metric the cell reports is read by ``metrics/<name>.py`` (a
``read(outcome)`` returning a number, or None where it finds nothing to
read). So a configuration, a mix or a per-layer metric is added as files
and ``BENCHMARK.json`` entries alone.

The configuration's ``env`` is applied before the port is imported, and
the build and kernel caches go to fixed directories in the checkout. The
port is measured; nothing here imports JAX or the JAX package, and a run
that finds either among its modules once the window has closed prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")
#: Fixed cache directories inside the checkout (listed in .gitignore).
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".portbench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".portbench_cache/triton"}

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


class NoCard(RuntimeError):
    pass


@dataclass
class Check:
    """One number compared with its limit: at most ``max`` or at least
    ``min``."""

    name: str
    value: float
    max: Optional[float] = None
    min: Optional[float] = None

    @property
    def passed(self) -> bool:
        return (self.max is None or self.value <= self.max) and \
            (self.min is None or self.value >= self.min)

    def limit(self) -> dict:
        return {"max": self.max} if self.max is not None \
            else {"min": self.min}

    def line(self) -> str:
        op, lim = ("<=", self.max) if self.max is not None \
            else (">=", self.min)
        return f"check {self.name}: {self.value} (limit {op} {lim})"


@dataclass
class Cell:
    """What a mode is handed: the cell's files, the run's arguments, the
    device, the process's start on the host clock, and ``patch``, a
    context-manager factory entered around the window (the control and
    the fault tests put something in the program's place with it)."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    patch: Callable = contextlib.nullcontext


@dataclass
class Outcome:
    """What a mode measured. ``readings`` holds the raw numbers the metric
    readers take theirs from; ``window`` is the run's trace.Window."""

    setup_s: float
    attempted: int
    failed: int
    checks: list
    readings: dict
    window: object
    memory_peak_bytes: int = 0
    info: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(c.passed for c in self.checks)


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "portbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_mode(name: str):
    return importlib.import_module(f"portbench.modes.{name}")


def load_metric(name: str, root: Path = ROOT):
    """The reader of metric ``name``: ``metrics/<name>.py``, loaded by
    path (metric names hold dots)."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, name: str, traced: bool) -> list:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def apply_env(config: dict, root: Path = ROOT) -> None:
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(root / rel)
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = json.loads(json.dumps(base))
    for key, val in (over or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], val)
        else:
            out[key] = val
    return out


def run(name: str, seed: int, seconds: float, traced: bool, t0: float,
        device=None, patch: Callable = contextlib.nullcontext,
        overrides: Optional[dict] = None, root: Path = ROOT
        ) -> tuple[dict, Outcome]:
    """Run cell ``name`` once; returns (the result line's object, the
    outcome). ``device`` None means the card, and raises :class:`NoCard`
    without enough of them; ``overrides`` ({"config": ..., "traffic":
    ...}) shrink a cell for the CPU tests."""
    bench = load_benchmark(root)
    w = workload(bench, name)
    overrides = overrides or {}
    config = _merge(load_config(bench, w["config"], root),
                    overrides.get("config"))
    traffic = _merge(load_traffic(w["traffic"], root),
                     overrides.get("traffic"))
    apply_env(config, root)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < w["chips"]:
            raise NoCard(f"{torch.cuda.device_count()} card(s), the cell "
                         f"asks for {w['chips']}")
        device = "cuda:0"
    dev = torch.device(device)
    cell = Cell(name, config, traffic, int(seed), float(seconds),
                bool(traced), dev, t0, patch)
    outcome = load_mode(traffic["mode"]).run(cell)
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        value = load_metric(m["name"], root).read(outcome)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = dev.type == "cuda"
    device_out = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": w["chips"] if cuda else 1,
        "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_out}
    reading = outcome.window.reading
    if traced and reading is not None:
        device_out["busy_s"] = reading.busy_s
        device_out["window_s"] = reading.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in reading.device_ops],
            "idle_gaps": reading.idle_gaps}
    result["checks"] = {c.name: dict(value=c.value, **c.limit())
                        for c in outcome.checks}
    return result, outcome


def parse_args(argv: list) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m portbench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list, t0: float, device=None,
         overrides: Optional[dict] = None, root: Path = ROOT) -> int:
    """The command: one run of one cell. Exits 3 without the card(s) the
    cell asks for, 4 where JAX or the JAX package was loaded, and prints
    the result as the last line of standard output otherwise; each number
    compared goes to standard error, last, beside its limit."""
    args = parse_args(argv)
    try:
        result, outcome = run(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0, device=device,
                              overrides=overrides, root=root)
    except NoCard as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return EXIT_NO_CARD
    found = forbidden_modules()
    if found:
        print(f"portbench: no result: the run loaded {found}",
              file=sys.stderr)
        return EXIT_FORBIDDEN
    print("portbench: " + json.dumps(outcome.info), flush=True)
    for check in outcome.checks:
        print(check.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
