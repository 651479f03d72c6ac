"""Configuration loading: flags > TOML > defaults.

The port's copy of ``seaweedfs_tpu/util/config.py``: each command's
argparse flags are the primary surface; a TOML file fills in the
sections the port reads; hard defaults sit underneath.

:data:`SCAFFOLDS` holds the templates of the sections the port reads —
``[pipeline]`` (pipeline/pipe.py), ``[mesh]`` (parallel/mesh.py),
``[flight]`` (pipeline/flight.py), ``[cache]`` (cache/chunk_cache.py),
``[qos]`` (util/httpserver.py, the S3 gateway), ``[tracing]``
(util/tracing.py), ``[telemetry]`` (cluster/telemetry.py), ``[profiler]``
(util/profiler.py) and ``[slo]`` (the master's SLO engine) — each text
byte-equal to the JAX package's, so a file written for one package reads
the same in the other. (The ``[flight]`` text names the JAX package's environment
variable; the port's is ``SEAWEEDFS_TORCH_FLIGHT``.) The other
sections' templates arrive with the modules that read them.
"""

from __future__ import annotations

from pathlib import Path

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11
    tomllib = None  # fall back to the subset parser below

SCAFFOLDS = {
    "pipeline": """\
# pipeline.toml — overlapped EC ingest plane (docs/pipeline.md).
[pipeline]
depth = 2                        # stage-queue depth (double buffering)
batch_bytes = 268435456          # max input bytes per device batch
grouped_batch_bytes = 67108864   # per-batch clamp while grouping
group_cap = 0                    # max batches/dispatch; 0 = env default
writer_threads = 4               # positioned shard-write pool width
writer_queue_depth = 4           # pending writes per writer thread
pool_buffers = 0                 # reusable host buffers; 0 = derive
feedback = true                  # latency-fed group-size controller
overlapped = true                # false = synchronous reference path
preallocate = true               # size shard files up front
double_buffer = false            # two-deep H2D lookahead (mesh path)
""",
    "flight": """\
# flight.toml — pipeline flight recorder (docs/pipeline.md).
# Per-batch lifecycle events (read/H2D/dispatch/D2H/write/recycle)
# into a bounded preallocated ring; export with `pipeline.dump -trace`
# and read the verdict with `pipeline.analyze`. SEAWEED_FLIGHT=1 arms
# it from the environment without a config file.
[flight]
enabled = false                  # arm the per-batch event recorder
capacity = 65536                 # ring slots (oldest events evicted)
""",
    "cache": """\
# cache.toml — tiered chunk cache for read paths (docs/cache.md).
[cache]
memory_bytes = 67108864          # in-memory tier capacity (64 MiB)
admission_max_fraction = 0.125   # reject blobs larger than this share
ttl_seconds = 0                  # 0 disables time-based expiry
protected_fraction = 0.8         # SLRU protected-segment share

[cache.disk]
dir = ""                         # empty disables the on-disk tier
capacity_bytes = 268435456       # 256 MiB across all segment files
segments = 4
""",
    "qos": """\
# qos.toml — per-tenant QoS at the S3 gateway (docs/ingress.md).
# Tenants are authenticated SigV4 identity names; unauthenticated
# traffic is the "anonymous" tenant. Priority 0 = guaranteed (never
# pressure-shed); higher priorities shed earlier as queue pressure
# rises (class threshold = watermark ** priority).
[qos]
enabled = true
default_class = "standard"       # class for unmapped tenants
watermark = 0.75                 # base of the priority shed ladder

[qos.class.gold]
priority = 0                     # guaranteed: only its own caps apply
rate_per_second = 0              # token-bucket refill; 0 = unlimited
burst = 0                        # bucket size; 0 = max(1, rate)
concurrency = 0                  # in-flight cap; 0 = unlimited

[qos.class.standard]
priority = 1
rate_per_second = 0
burst = 0
concurrency = 0

[qos.class.bronze]
priority = 2
rate_per_second = 50
burst = 100
concurrency = 16

[qos.tenant]
# alice = "gold"                 # identity name -> class name
# mallory = "bronze"
""",
    "tracing": """\
# tracing.toml — end-to-end request tracing (docs/observability.md).
[tracing]
enabled = true                   # false strips all span bookkeeping
ring_size = 256                  # completed traces kept per process
slow_threshold_seconds = 1.0     # slower roots log a span-tree line
push_threshold_seconds = 1.0     # slower/errored roots push to master
collector_url = ""               # master host:port override (servers
                                 # that know their master set it)
collector_ring_size = 256        # stitched traces kept on the master
""",
    "telemetry": """\
# telemetry.toml — heartbeat-carried per-volume hot stats
# (docs/observability.md). Applies to volume servers; the master's
# registry always accepts whatever snapshots arrive.
[telemetry]
enabled = true                   # false makes the collector a no-op
""",
    "profiler": """\
# profiler.toml — continuous sampling profiler (docs/observability.md).
[profiler]
enabled = true                   # always-on low-rate sampler thread
hz = 1.0                         # background sampling rate
top_k = 5                        # hot stacks carried on heartbeats
max_stacks = 512                 # distinct collapsed stacks retained
""",
    "slo": """\
# slo.toml — master-side SLO burn-rate engine (docs/observability.md).
# Latency objectives are "no more than 1% of ops slower than the
# target"; availability is the fraction of ops that must succeed.
# Burn rate = observed bad-event rate / budgeted bad-event rate,
# evaluated over fast (5m + 1h) and slow (6h) windows (SRE multiwindow
# multi-burn-rate alerting): fast windows page, the slow window warns.
[slo]
enabled = true
read_p99_ms = 250.0              # volume read latency target; 0 = off
write_p99_ms = 500.0             # volume write latency target; 0 = off
availability = 0.999             # min ok fraction; 0 = off
evaluation_interval_seconds = 5.0
fast_burn_threshold = 14.4       # burns 2% of a 30d budget in 1h
slow_burn_threshold = 6.0        # burns 5% of a 30d budget in 6h
fast_window_seconds = 300.0      # paired with fast_long_window
fast_long_window_seconds = 3600.0
slow_window_seconds = 21600.0
""",
    "mesh": """\
# mesh.toml — explicit (dp, sp) device mesh for EC compute (docs/mesh.md).
# Disabled: multi-chip accelerators auto-shard, everything else takes
# the single-device host path. Enabled: encode/rebuild/batch shard over
# ALL local devices; dp*sp must equal the device count (0 = derive the
# most-square factorization). The -mesh shell flag overrides per command.
[mesh]
enabled = false
dp = 0                           # volume/batch axis; 0 = derive
sp = 0                           # stripe (byte-range) axis; 0 = derive
""",
}


def load(path: str | Path) -> dict:
    """Parse one TOML file into nested dicts; missing file -> {}."""
    p = Path(path)
    if not p.exists():
        return {}
    if tomllib is not None:
        with open(p, "rb") as f:
            return tomllib.load(f)
    return _parse_toml_subset(p.read_text())


def _parse_toml_subset(text: str) -> dict:
    """Parser for the TOML subset the scaffolds use — ``[a.b]`` tables
    and string/int/float/bool scalars with ``#`` comments. Interpreters
    without tomllib (and without a tomli wheel) land here; anything
    fancier than the subset raises rather than mis-parsing."""
    root: dict = {}
    table = root
    for lineno, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        if not s or s.startswith("#"):
            continue
        if s.startswith("[") and s.endswith("]"):
            table = root
            for part in s[1:-1].split("."):
                table = table.setdefault(part.strip(), {})
            continue
        key, eq, raw = s.partition("=")
        if not eq:
            raise ValueError(
                f"toml line {lineno}: expected key = value: {line!r}")
        table[key.strip()] = _parse_scalar(raw.strip(), lineno)
    return root


def _parse_scalar(raw: str, lineno: int):
    if raw.startswith('"'):
        end = raw.find('"', 1)
        while end != -1 and raw[end - 1] == "\\":
            end = raw.find('"', end + 1)
        if end == -1:
            raise ValueError(f"toml line {lineno}: unterminated string")
        return raw[1:end].replace('\\"', '"').replace("\\\\", "\\")
    raw = raw.split("#", 1)[0].strip()
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(raw, 0)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"toml line {lineno}: unsupported value {raw!r}") from None


def lookup(conf: dict, dotted: str, default=None):
    """conf['a']['b']['c'] via 'a.b.c', with default."""
    cur = conf
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def scaffold(name: str) -> str:
    if name not in SCAFFOLDS:
        raise KeyError(f"no scaffold named {name!r}; "
                       f"have {sorted(SCAFFOLDS)}")
    return SCAFFOLDS[name]
