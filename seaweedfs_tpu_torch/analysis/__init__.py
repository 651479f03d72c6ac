"""seaweedlint — project-native static analysis for seaweedfs_tpu_torch.

Go's SeaweedFS leans on ``go vet`` and the race detector; this package
is the Python-side equivalent, specialized to the concurrency and
resource idioms THIS codebase actually uses (lock sites across cache/,
cluster/, storage/, filer/, span and handle lifecycles, a
Prometheus-text metrics registry, pinned host buffers and their
asynchronous copies to and from the card). It is pure stdlib ``ast`` —
no torch, no grpc, nothing of the JAX package — so it runs anywhere in
seconds. It reads source text only and touches no device, so the
port's rule that an entry point runs on the card unless asked for the
CPU has nothing to act on here.

Rule families (the README's port section holds the catalog):

- SW1xx  locks: a cross-module lock-acquisition graph built from
  ``with <lock>:`` sites plus a resolved call graph; reports
  lock-order cycles (SW101, error), nested-acquire sites (SW102,
  info), and blocking I/O — sleep/socket/RPC/subprocess (error) or
  file I/O (warning) — performed while a lock is held (SW103).
- SW2xx  resources: files/sockets/channels opened without ``with`` /
  ``finally`` closure (SW201), tracing spans not context-managed
  (SW202).
- SW3xx  exceptions: handlers that swallow silently — ``pass`` with no
  logging (SW301; error in server/heartbeat loops, else warning),
  bare ``except:`` (SW302, error).
- SW4xx  metrics: unbounded label cardinality at util/stats call
  sites — f-string / ``str()`` / %-format label values (SW401, error),
  variable label values and dynamic metric names (SW402, info).
- SW5xx  pooled host buffers (buffer_rules.py); SW503 is the torch
  form: a host buffer written or released while an asynchronous copy
  from or into it may be in flight.
- SW6xx  network calls outside util/retry.py, SW8xx thread roles and
  shared state, SW9xx ``os.replace`` durability.
- SW7xx  torch dispatch hazards (torch_rules.py): builds in loops,
  host syncs in loops, unhashable arguments to cached builders,
  per-device placement loops.

Every family but SW503 and SW7xx keeps the JAX package's ids,
severities and messages, and gives the same findings on the same
source text.

Findings diff against a checked-in baseline
(``seaweedfs_tpu_torch/analysis/baseline.json``) so CI fails only on
NEW violations; inline ``# seaweedlint: disable=SW103 — reason``
pragmas suppress deliberate sites at the line.

Run: ``python -m seaweedfs_tpu_torch.analysis`` (default path
``seaweedfs_tpu_torch``, result cache ``.seaweedlint_torch_cache.json``).

The runtime complement — a lock-order *recorder* that watches real
acquisitions under ``SEAWEEDFS_TORCH_LOCKCHECK=1`` — lives in
``seaweedfs_tpu_torch/util/lockcheck.py``.
"""

from .findings import Finding, SEVERITIES  # noqa: F401
from .engine import analyze_paths, analyze_sources  # noqa: F401
from .baseline import load_baseline, write_baseline, diff_baseline  # noqa: F401
