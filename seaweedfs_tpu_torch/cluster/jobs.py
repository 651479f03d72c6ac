"""Cluster maintenance plane: leased job orchestration.

The port of ``seaweedfs_tpu/cluster/jobs.py``.
Upstream SeaweedFS runs ``ec.encode`` / ``volume.grow`` as one shell
process driving every rpc itself; a sweep over many volumes then
bottlenecks on (and dies with) that one coordinator. This module moves
the work-list into the master: a :class:`JobManager` holds durable
per-volume tasks (``ec_encode``, ``ec_rebuild``, ``vacuum``,
``replicate``, ``replica_drop``, ``scrub``) that volume servers pull
with **leases** —

- a worker claims a task over HTTP (``POST /cluster/jobs/claim``,
  leader-proxied like every /cluster/* write);
- the lease renews implicitly while the worker's heartbeat carries a
  ``Heartbeat.job_progress`` snapshot naming the task;
- a lease that outlives its worker expires, and the task re-queues
  with the dead worker excluded, so a mid-sweep kill reassigns rather
  than wedges;
- terminal transitions checkpoint to ``<meta_dir>/jobs.json`` in the
  JAX package's format — a restarted master (of either package)
  resumes the sweep where it stopped instead of re-encoding finished
  volumes.

:class:`JobWorker` is the volume-server half: a poll thread claims one
task at a time and executes it against the local store, on the server's
device — EC encode runs through the overlapped pipeline
(``encode_volume``), the other kinds through the server's own gRPC
servicer. A task that fails is reported failed with its error text;
nothing retries it on the host.

One behaviour differs from the JAX package on purpose. There an
exclusion is a ban: a worker whose attempt failed (or whose lease
expired) never gets the task again, so a task whose only eligible
worker is excluded — an ``ec_encode`` of a volume with one holder
after one transient failure — stays pending forever and its job never
ends. Here an exclusion is a preference: when no live worker outside
``excluded`` is eligible, an excluded one may claim the task again.
Attempts still count, so ``max_attempts`` ends it as ``failed``. While
another eligible worker is live, the excluded one stays excluded.

On top of the queue, :class:`PolicyEngine` closes the loop the
telemetry and usage planes only observe: cold **full** volumes (read-rate
EWMA under ``cold_read_ops_per_second``) are queued for EC encode, hot
volumes get replicas grown, cooling ones shrunk — with hysteresis (grow
above ``hot``, shrink only below ``cool`` < ``hot``), a per-volume
cooldown dwell, a per-tick submission cap, and a ``[jobs]`` kill switch.
Its decisions equal the JAX engine's on the same rows. A sealed volume's
``ec_encode`` runs on the holder's job worker, so a policy tick ends in
the GF(2^8) kernel on the card.

The master passes ``on_commit`` (its cache-invalidation fan-out).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Iterable, Optional

from ..ops import rs_cuda
from ..pb import master_pb2, volume_server_pb2
from ..pipeline import encode as encode_mod
from ..pipeline.scheme import DEFAULT_SCHEME, EcScheme
from ..storage.superblock import ReplicaPlacement
from ..util import glog, retry
from ..util.stats import Metrics

#: Task kinds the manager accepts and workers know how to execute.
KINDS = ("ec_encode", "ec_rebuild", "vacuum", "replicate", "replica_drop",
         "scrub")

#: Kinds that change what a volume's bytes mean — their commits fan a
#: cache-invalidation event out to every subscribed gateway cache.
MUTATING_KINDS = frozenset(
    ("ec_encode", "ec_rebuild", "vacuum", "replica_drop"))

_TERMINAL = ("done", "failed")

_ENABLED = True


def configure(enabled: Optional[bool] = None) -> None:
    """Module kill switch: off means workers stop claiming, the
    manager hands out nothing, and heartbeats drop the job_progress
    piggyback."""
    global _ENABLED
    if enabled is not None:
        _ENABLED = bool(enabled)


def configure_from(conf: dict) -> None:
    """Apply a ``[jobs]`` config-file section's module flag."""
    j = conf.get("jobs") if isinstance(conf, dict) else None
    if isinstance(j, dict):
        configure(enabled=j.get("enabled"))


def enabled() -> bool:
    return _ENABLED


class JobError(RuntimeError):
    pass


class _Task:
    __slots__ = ("task_id", "job_id", "kind", "volume_id", "collection",
                 "params", "state", "worker", "lease_expires", "attempts",
                 "excluded", "error", "fraction", "completed_at")

    def __init__(self, task_id: str, job_id: str, kind: str,
                 volume_id: int, collection: str, params: dict):
        self.task_id = task_id
        self.job_id = job_id
        self.kind = kind
        self.volume_id = volume_id
        self.collection = collection
        self.params = params
        self.state = "pending"        # pending|leased|done|failed
        self.worker = ""
        self.lease_expires = 0.0
        self.attempts = 0
        self.excluded: list[str] = []
        self.error = ""
        self.fraction = 0.0
        self.completed_at = 0.0

    def to_map(self) -> dict:
        return {"taskId": self.task_id, "jobId": self.job_id,
                "kind": self.kind, "volumeId": self.volume_id,
                "collection": self.collection, "params": self.params,
                "state": self.state, "worker": self.worker,
                "attempts": self.attempts,
                "excluded": list(self.excluded), "error": self.error,
                "fraction": round(self.fraction, 3)}

    @classmethod
    def from_map(cls, d: dict) -> "_Task":
        t = cls(d["taskId"], d["jobId"], d["kind"], int(d["volumeId"]),
                d.get("collection", ""), dict(d.get("params") or {}))
        # Leases do not survive a master restart: a leased task resumes
        # as pending (its worker may still complete it; a completion
        # for a non-leased task is treated as stale and re-executed).
        t.state = d.get("state", "pending")
        if t.state == "leased":
            t.state = "pending"
        t.attempts = int(d.get("attempts", 0))
        t.excluded = list(d.get("excluded") or [])
        t.error = d.get("error", "")
        t.fraction = 1.0 if t.state == "done" else 0.0
        return t


class _Job:
    __slots__ = ("job_id", "kind", "collection", "parallel", "state",
                 "submitted_by", "created", "tasks")

    def __init__(self, job_id: str, kind: str, collection: str,
                 parallel: int, submitted_by: str, created: float):
        self.job_id = job_id
        self.kind = kind
        self.collection = collection
        self.parallel = parallel      # 0 = unlimited concurrent leases
        self.state = "active"         # active|paused|cancelled|done|failed
        self.submitted_by = submitted_by
        self.created = created
        self.tasks: list[_Task] = []

    def to_map(self, with_tasks: bool = True,
               limit: Optional[int] = None) -> dict:
        counts: dict[str, int] = {}
        for t in self.tasks:
            counts[t.state] = counts.get(t.state, 0) + 1
        out = {"jobId": self.job_id, "kind": self.kind,
               "collection": self.collection, "parallel": self.parallel,
               "state": self.state, "submittedBy": self.submitted_by,
               "created": self.created, "taskCounts": counts,
               "total": len(self.tasks)}
        if with_tasks:
            tasks = self.tasks
            if limit is not None and 0 < limit < len(tasks):
                # Non-terminal tasks first: a truncated view of a
                # million-task sweep should show the live work, and
                # ``tasksOmitted`` says how much was cut.
                live = [t for t in tasks if t.state in
                        ("pending", "leased")]
                rest = [t for t in tasks if t.state not in
                        ("pending", "leased")]
                tasks = (live + rest)[:limit]
                out["tasksOmitted"] = len(self.tasks) - len(tasks)
            out["tasks"] = [t.to_map() for t in tasks]
        return out


class JobManager:
    """Master-side durable work-lists handed out via lease-based pull.

    Thread-safe; everything mutating runs under one lock. Durable
    transitions (submit, task done/failed, pause/resume/cancel)
    checkpoint to ``checkpoint_path``; leases and renewals are
    volatile by design — a restarted master re-queues in-flight tasks
    and lets stale completions land as no-ops.
    """

    def __init__(self, topology=None,
                 checkpoint_path=None,
                 lease_seconds: float = 15.0,
                 max_attempts: int = 3,
                 clock=time.time,
                 on_commit=None):
        self.topology = topology
        self.checkpoint_path = checkpoint_path
        self.lease_seconds = lease_seconds
        self.max_attempts = max_attempts
        self.clock = clock
        #: Called with a task after it commits as done.
        self.on_commit = on_commit
        #: Own registry, ``seaweed_`` namespace, rendered by the
        #: master's /metrics.
        self.metrics = Metrics(namespace="seaweed")
        self._lock = threading.Lock()
        self._jobs: dict[str, _Job] = {}
        self._order: list[str] = []           # FIFO submit order
        self._next_id = 1
        self.expired_total = 0
        self.stale_completions = 0
        if checkpoint_path is not None:
            self._load()

    # ---------------- submission ----------------

    def submit(self, kind: str, volume_ids: Iterable[int],
               collection: str = "", params: Optional[dict] = None,
               parallel: int = 0, submitted_by: str = "") -> dict:
        if kind not in KINDS:
            raise ValueError(f"unknown job kind {kind!r}; want one of "
                             f"{', '.join(KINDS)}")
        vids = sorted({int(v) for v in volume_ids})
        if not vids:
            raise ValueError(f"job {kind}: no volumes to work on")
        with self._lock:
            job_id = f"j{self._next_id}"
            self._next_id += 1
            job = _Job(job_id, kind, collection, max(0, int(parallel)),
                       submitted_by, self.clock())
            for i, vid in enumerate(vids, 1):
                job.tasks.append(_Task(f"{job_id}.t{i}", job_id, kind,
                                       vid, collection,
                                       dict(params or {})))
            self._jobs[job_id] = job
            self._order.append(job_id)
            self._checkpoint_locked()
            self._refresh_gauges_locked()
            glog.info("jobs: submitted %s %s over %d volume(s)%s",
                      job_id, kind, len(vids),
                      f" [{collection}]" if collection else "")
            return job.to_map(with_tasks=False)

    # ---------------- worker pull ----------------

    def _placed(self, t: _Task, worker: str) -> bool:
        """May ``worker`` execute ``t`` by placement alone? Permissive
        without a topology, which is what the unit tests drive."""
        if self.topology is None:
            return True
        node = self.topology.nodes.get(worker)
        if node is None:
            return False
        holds = (t.collection, t.volume_id) in node.volumes
        if t.kind in ("ec_encode", "vacuum", "replica_drop"):
            return holds
        if t.kind in ("ec_rebuild", "scrub"):
            # scrub covers both forms: a node scrubs the needles it
            # holds and/or the EC shards it hosts
            return holds or (t.collection, t.volume_id) in node.ec_shards
        if t.kind == "replicate":
            return (not holds) and node.free_slots > 0
        return False

    def _eligible(self, t: _Task, worker: str) -> bool:
        """May ``worker`` execute ``t``? An excluded worker may, when
        the live topology holds no eligible worker outside ``excluded``
        (module docstring); without a topology an exclusion is a ban,
        as in the JAX package."""
        if not self._placed(t, worker):
            return False
        if worker not in t.excluded:
            return True
        if self.topology is None:
            return False
        return not any(url not in t.excluded and self._placed(t, url)
                       for url in list(self.topology.nodes))

    def _replicate_source(self, t: _Task, worker: str) -> str:
        """A live holder to VolumeCopy from, chosen at claim time so a
        re-queued task never chases a reaped node."""
        src = str(t.params.get("source", "") or "")
        if src and src != worker:
            return src
        if self.topology is None:
            return src
        for n in self.topology.lookup_volume(t.volume_id, t.collection):
            if n.url != worker:
                return n.url
        return ""

    def claim(self, worker: str) -> Optional[dict]:
        """Hand ``worker`` its next task, FIFO over active jobs, or
        None. The lease starts now and renews on every heartbeat that
        names the task."""
        if not worker or not _ENABLED:
            return None
        now = self.clock()
        with self._lock:
            for job_id in self._order:
                job = self._jobs[job_id]
                if job.state != "active":
                    continue
                if job.parallel:
                    leased = sum(1 for t in job.tasks
                                 if t.state == "leased")
                    if leased >= job.parallel:
                        continue
                for t in job.tasks:
                    if t.state != "pending" or not self._eligible(
                            t, worker):
                        continue
                    source = ""
                    if t.kind == "replicate":
                        source = self._replicate_source(t, worker)
                        if not source:
                            continue     # no live holder to copy from
                    t.state = "leased"
                    t.worker = worker
                    t.attempts += 1
                    t.lease_expires = now + self.lease_seconds
                    t.fraction = 0.0
                    self._refresh_gauges_locked()
                    glog.v(1, "jobs: %s leased to %s (attempt %d)",
                           t.task_id, worker, t.attempts)
                    return {"taskId": t.task_id, "jobId": job_id,
                            "kind": t.kind, "volumeId": t.volume_id,
                            "collection": t.collection,
                            "params": dict(t.params), "source": source,
                            "leaseSeconds": self.lease_seconds}
        return None

    def renew(self, worker: str, progress) -> int:
        """Heartbeat piggyback: extend the lease of every task the
        worker still reports, and fold its progress fraction in.
        ``progress`` is a ``master_pb2.JobProgress`` (or anything with
        a ``tasks`` iterable of task_id/fraction carriers)."""
        now = self.clock()
        renewed = 0
        with self._lock:
            by_id = {t.task_id: t for j in self._jobs.values()
                     for t in j.tasks}
            for tp in progress.tasks:
                t = by_id.get(tp.task_id)
                if t is None or t.state != "leased" or t.worker != worker:
                    continue
                t.lease_expires = now + self.lease_seconds
                t.fraction = min(1.0, max(t.fraction, tp.fraction))
                renewed += 1
        return renewed

    def complete(self, worker: str, task_id: str, ok: bool,
                 error: str = "") -> dict:
        """Authoritative task completion from the executing worker. A
        completion from anyone but the current lease holder is stale
        (the lease expired and the task moved on) — counted, ignored:
        over-execution is safe for every kind here (encode/vacuum/
        rebuild are idempotent; copy/delete re-check state)."""
        commit: Optional[_Task] = None
        with self._lock:
            t = None
            for j in self._jobs.values():
                for cand in j.tasks:
                    if cand.task_id == task_id:
                        t = cand
                        break
            if t is None:
                return {"error": f"unknown task {task_id}"}
            if t.state != "leased" or t.worker != worker:
                self.stale_completions += 1
                glog.v(1, "jobs: stale completion of %s by %s ignored",
                       task_id, worker)
                return {"stale": True, "state": t.state}
            if ok:
                t.state = "done"
                t.fraction = 1.0
                t.error = ""
                t.completed_at = self.clock()
                self.metrics.counter("jobs_tasks_completed_total",
                                     kind=t.kind).inc()
                commit = t
            else:
                t.error = error or "failed"
                if worker not in t.excluded:
                    t.excluded.append(worker)
                if t.attempts >= self.max_attempts:
                    t.state = "failed"
                    t.completed_at = self.clock()
                    glog.warning("jobs: %s failed terminally after %d "
                                 "attempts: %s", task_id, t.attempts,
                                 t.error)
                else:
                    t.state = "pending"
                t.worker = ""
                t.lease_expires = 0.0
            self._maybe_finish_job_locked(self._jobs[t.job_id])
            self._checkpoint_locked()
            self._refresh_gauges_locked()
            state = t.state
        if commit is not None and self.on_commit is not None:
            try:
                self.on_commit(commit)
            except Exception as e:  # noqa: BLE001 — fan-out best-effort
                glog.warning("jobs: on_commit for %s failed: %s",
                             task_id, e)
        return {"taskId": task_id, "state": state}

    def _maybe_finish_job_locked(self, job: _Job) -> None:
        if job.state not in ("active", "paused"):
            return
        if all(t.state in _TERMINAL for t in job.tasks):
            job.state = "done" if all(t.state == "done"
                                      for t in job.tasks) else "failed"
            glog.info("jobs: %s %s (%d task(s))", job.job_id, job.state,
                      len(job.tasks))

    # ---------------- lease expiry / dead workers ----------------

    def expire(self, now: Optional[float] = None) -> list[str]:
        """Re-queue tasks whose lease ran out (dead or wedged worker),
        excluding the holder so the retry lands elsewhere when it can.
        Runs every master pulse off the reap loop."""
        now = self.clock() if now is None else now
        out: list[str] = []
        with self._lock:
            for job in self._jobs.values():
                for t in job.tasks:
                    if t.state != "leased" or t.lease_expires > now:
                        continue
                    glog.warning("jobs: lease on %s expired (worker %s);"
                                 " re-queueing", t.task_id, t.worker)
                    if t.worker and t.worker not in t.excluded:
                        t.excluded.append(t.worker)
                    t.worker = ""
                    t.lease_expires = 0.0
                    self.expired_total += 1
                    self.metrics.counter("jobs_lease_expired_total").inc()
                    if t.attempts >= self.max_attempts:
                        t.state = "failed"
                        t.error = t.error or "lease expired"
                        t.completed_at = now
                    else:
                        t.state = "pending"
                    out.append(t.task_id)
                if out:
                    self._maybe_finish_job_locked(job)
            if out:
                self._checkpoint_locked()
                self._refresh_gauges_locked()
        return out

    def forget_worker(self, worker: str) -> list[str]:
        """Immediate re-queue when the topology reaps a dead node — no
        need to sit out the rest of the lease."""
        with self._lock:
            for job in self._jobs.values():
                for t in job.tasks:
                    if t.state == "leased" and t.worker == worker:
                        t.lease_expires = 0.0
        return self.expire()

    # ---------------- operator controls ----------------

    def _get_job(self, job_id: str) -> _Job:
        job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id}")
        return job

    def pause(self, job_id: str) -> dict:
        with self._lock:
            job = self._get_job(job_id)
            if job.state == "active":
                job.state = "paused"
                self._checkpoint_locked()
            return job.to_map(with_tasks=False)

    def resume(self, job_id: str) -> dict:
        with self._lock:
            job = self._get_job(job_id)
            if job.state == "paused":
                job.state = "active"
                self._checkpoint_locked()
            return job.to_map(with_tasks=False)

    def cancel(self, job_id: str) -> dict:
        """Stop handing the job's tasks out. In-flight leases are left
        to finish (their completions still land) — cancellation stops
        the sweep, it does not roll back a half-encoded volume."""
        with self._lock:
            job = self._get_job(job_id)
            if job.state in ("active", "paused"):
                job.state = "cancelled"
                self._checkpoint_locked()
                self._refresh_gauges_locked()
            return job.to_map(with_tasks=False)

    # ---------------- views ----------------

    def active_volume_ids(self) -> set[int]:
        """Volumes with non-terminal tasks in live jobs."""
        with self._lock:
            return {t.volume_id for j in self._jobs.values()
                    if j.state in ("active", "paused")
                    for t in j.tasks if t.state not in _TERMINAL}

    def to_map(self, with_tasks: bool = True,
               limit: Optional[int] = None) -> dict:
        with self._lock:
            jobs = [self._jobs[jid].to_map(with_tasks, limit=limit)
                    for jid in self._order]
            return {"enabled": _ENABLED,
                    "leaseSeconds": self.lease_seconds,
                    "maxAttempts": self.max_attempts,
                    "expiredTotal": self.expired_total,
                    "staleCompletions": self.stale_completions,
                    "jobs": jobs}

    def summary(self) -> dict:
        """Small per-state counts (the ``jobs`` block of the master's
        ``/debug/vars``)."""
        with self._lock:
            states: dict[str, int] = {}
            tasks: dict[str, int] = {}
            for j in self._jobs.values():
                states[j.state] = states.get(j.state, 0) + 1
                for t in j.tasks:
                    tasks[t.state] = tasks.get(t.state, 0) + 1
            return {"jobs": states, "tasks": tasks,
                    "expired": self.expired_total}

    def _refresh_gauges_locked(self) -> None:
        counts: dict[tuple[str, str], int] = {}
        job_states: dict[str, int] = {}
        for j in self._jobs.values():
            job_states[j.state] = job_states.get(j.state, 0) + 1
            for t in j.tasks:
                key = (t.kind, t.state)
                counts[key] = counts.get(key, 0) + 1
        # Zero every gauge already exported, then set live counts —
        # a drained state must read 0, not its last value.
        for (name, _labels, kind), m in list(
                self.metrics._metrics.items()):
            if kind == "gauge" and name in ("jobs_tasks", "jobs_jobs"):
                m.set(0)
        for (k, s), n in counts.items():
            self.metrics.gauge("jobs_tasks", kind=k, state=s).set(n)
        for s, n in job_states.items():
            self.metrics.gauge("jobs_jobs", state=s).set(n)

    # ---------------- durability ----------------

    def _checkpoint_locked(self) -> None:
        if self.checkpoint_path is None:
            return
        path = Path(self.checkpoint_path)
        doc = {"next_id": self._next_id,
               "jobs": [self._jobs[jid].to_map(with_tasks=True)
                        for jid in self._order]}
        tmp = path.with_suffix(path.suffix + ".tmp")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_text(json.dumps(doc), encoding="utf-8")
            tmp.replace(path)
        except OSError as e:
            glog.warning("jobs: checkpoint to %s failed: %s", path, e)

    def _load(self) -> None:
        path = Path(self.checkpoint_path)
        if not path.exists():
            return
        try:
            doc = json.loads(path.read_text(encoding="utf-8"))
        except (OSError, ValueError) as e:
            glog.warning("jobs: checkpoint %s unreadable (%s); starting "
                         "empty", path, e)
            return
        with self._lock:
            self._next_id = int(doc.get("next_id", 1))
            for jd in doc.get("jobs", ()):
                job = _Job(jd["jobId"], jd["kind"],
                           jd.get("collection", ""),
                           int(jd.get("parallel", 0)),
                           jd.get("submittedBy", ""),
                           float(jd.get("created", 0.0)))
                job.state = jd.get("state", "active")
                job.tasks = [_Task.from_map(td)
                             for td in jd.get("tasks", ())]
                self._jobs[job.job_id] = job
                self._order.append(job.job_id)
            self._refresh_gauges_locked()
        glog.info("jobs: resumed %d job(s) from %s", len(self._order),
                  path)


# --------------------------------------------------------------------------
# policy engine: telemetry/usage signals -> submitted jobs
# --------------------------------------------------------------------------


class PolicyEngine:
    """Turns the observability planes into autonomous maintenance.

    Every ``interval`` seconds (leader only, off the master's reap
    loop) the engine folds the topology + telemetry registry into
    per-volume rows and decides:

    - **ec_encode** — volume is full (read-only, or size past
      ``full_fraction`` of the limit) AND its cluster-wide read-rate
      EWMA sits under ``cold_read_ops_per_second``: seal it to EC.
    - **replicate** — read rate above ``hot_read_ops_per_second`` and
      fewer than ``max_replicas`` copies: grow a replica.
    - **replica_drop** — read rate below ``cool_read_ops_per_second``
      and more copies than the placement requires: shrink back.

    Chunk-cache warmth (cluster-wide hit ratio from telemetry) tilts
    the decisions: a warm volume's observed read rate is mostly cache
    hits, so sealing it to EC or dropping replicas would dump that
    absorbed load back onto disks the moment caches churn. Volumes at
    or above ``warm_cache_hit_ratio`` are never EC-encoded or shrunk,
    and replicate already at ``cool_read_ops_per_second`` instead of
    waiting for the hot threshold.

    Flap control is structural: grow and shrink thresholds are split
    (hysteresis band), every volume gets a ``cooldown_seconds`` dwell
    after any action, volumes with live tasks are skipped, and at most
    ``max_actions_per_tick`` jobs are submitted per evaluation.
    """

    def __init__(self, master=None, jobs: Optional[JobManager] = None,
                 clock=time.time):
        self.master = master
        self.jobs = jobs
        self.clock = clock
        self.enabled = False
        self.interval = 15.0
        self.cold_read_rate = 0.05
        self.full_fraction = 0.9
        self.hot_read_rate = 50.0
        self.cool_read_rate = 10.0
        self.warm_cache_ratio = 0.5
        self.max_replicas = 3
        self.cooldown = 120.0
        self.max_actions_per_tick = 2
        self.ticks = 0
        self.actions: deque = deque(maxlen=128)
        self._last_action: dict[int, float] = {}
        self._last_tick = 0.0
        self._lock = threading.Lock()

    def configure(self, conf: Optional[dict]) -> "PolicyEngine":
        """Apply a ``[jobs]`` section (also accepts the section
        itself). ``policy = true`` arms the engine; the section's
        ``enabled = false`` module switch still overrides it."""
        s = conf or {}
        if isinstance(s.get("jobs"), dict):
            s = s["jobs"]
        with self._lock:
            self.enabled = bool(s.get("policy", self.enabled))
            self.interval = float(
                s.get("policy_interval_seconds", self.interval))
            self.cold_read_rate = float(
                s.get("cold_read_ops_per_second", self.cold_read_rate))
            self.full_fraction = float(
                s.get("full_fraction", self.full_fraction))
            self.hot_read_rate = float(
                s.get("hot_read_ops_per_second", self.hot_read_rate))
            self.cool_read_rate = float(
                s.get("cool_read_ops_per_second", self.cool_read_rate))
            self.warm_cache_ratio = float(
                s.get("warm_cache_hit_ratio", self.warm_cache_ratio))
            self.max_replicas = int(
                s.get("max_replicas", self.max_replicas))
            self.cooldown = float(
                s.get("cooldown_seconds", self.cooldown))
            self.max_actions_per_tick = int(
                s.get("max_actions_per_tick", self.max_actions_per_tick))
            if self.cool_read_rate >= self.hot_read_rate:
                raise ValueError(
                    "[jobs] cool_read_ops_per_second must sit below "
                    "hot_read_ops_per_second (hysteresis band)")
        return self

    # ---------------- evaluation ----------------

    def cluster_rows(self) -> list[dict]:
        """Fold topology + telemetry into one row per volume."""
        topo = self.master.topology
        rates = topo.telemetry.volume_read_rates()
        warmth = topo.telemetry.volume_cache_warmth()
        rows: dict[int, dict] = {}
        # copies taken under the topology lock: a concurrent grow adds
        # to a node's volumes in place
        for _node, vols, _ec in topo.snapshot_holdings():
            for v in vols:
                vid = v.id
                r = rows.setdefault(vid, {
                    "volume_id": vid, "collection": v.collection,
                    "size": 0,
                    "read_only": False, "replicas": 0,
                    "placement": v.replica_placement,
                    "read_rate": rates.get(vid, 0.0),
                    "cache_warmth": warmth.get(vid, 0.0),
                    "is_ec": False})
                r["replicas"] += 1
                r["size"] = max(r["size"], v.size)
                r["read_only"] = r["read_only"] or v.read_only
        for vid in list(topo.ec_locations):
            if vid in rows:
                rows[vid]["is_ec"] = True
        for r in rows.values():
            r["limit"] = topo.volume_size_limit
        return [rows[vid] for vid in sorted(rows)]

    def evaluate(self, rows: Iterable[dict],
                 now: Optional[float] = None) -> list[dict]:
        """Pure-ish decision pass over volume rows; records cooldown
        state and returns the actions to submit. Split from tick() so
        hysteresis is unit-testable without a cluster."""
        now = self.clock() if now is None else now
        busy = self.jobs.active_volume_ids() if self.jobs else set()
        acts: list[dict] = []
        with self._lock:
            for r in rows:
                if len(acts) >= self.max_actions_per_tick:
                    break
                vid = r["volume_id"]
                if vid in busy:
                    continue
                if now - self._last_action.get(vid, -1e18) < self.cooldown:
                    continue
                rate = float(r.get("read_rate", 0.0))
                warm = float(r.get("cache_warmth", 0.0)) \
                    >= self.warm_cache_ratio
                action = ""
                if not r.get("is_ec"):
                    limit = int(r.get("limit", 0) or 0)
                    full = bool(r.get("read_only")) or (
                        limit > 0 and r.get("size", 0)
                        >= self.full_fraction * limit)
                    base = ReplicaPlacement.parse(
                        r.get("placement", "000")).copy_count()
                    grow_at = self.cool_read_rate if warm \
                        else self.hot_read_rate
                    if full and rate <= self.cold_read_rate \
                            and not warm:
                        action = "ec_encode"
                    elif (rate >= grow_at
                          and r.get("replicas", 1) < self.max_replicas):
                        action = "replicate"
                    elif (rate <= self.cool_read_rate and not warm
                          and r.get("replicas", 1) > base):
                        action = "replica_drop"
                if not action:
                    continue
                self._last_action[vid] = now
                act = {"ts": now, "action": action, "volumeId": vid,
                       "collection": r.get("collection", ""),
                       "readRate": round(rate, 3),
                       "cacheWarmth":
                           round(float(r.get("cache_warmth", 0.0)), 3),
                       "replicas": r.get("replicas", 1)}
                self.actions.append(act)
                if self.jobs is not None:
                    self.jobs.metrics.counter(
                        "jobs_policy_actions_total",
                        action=action).inc()
                acts.append(act)
        return acts

    def maybe_tick(self) -> None:
        """Interval-gated tick, called from the master's reap loop
        every pulse (leader checks live with the caller)."""
        if not self.enabled or not _ENABLED:
            return
        now = self.clock()
        if now - self._last_tick < self.interval:
            return
        self._last_tick = now
        try:
            self.tick(now)
        except Exception as e:  # noqa: BLE001 — policy must not die
            glog.warning("jobs: policy tick failed: %s: %s",
                         type(e).__name__, e)

    def tick(self, now: Optional[float] = None) -> list[dict]:
        # only the master's single reap loop calls tick()
        # seaweedlint: disable=SW802 — single reap-loop caller
        self.ticks += 1
        acts = self.evaluate(self.cluster_rows(), now)
        for a in acts:
            glog.info("jobs: policy -> %s volume %d (rate %.2f/s, "
                      "%d replica(s))", a["action"], a["volumeId"],
                      a["readRate"], a["replicas"])
            self.jobs.submit(a["action"], [a["volumeId"]],
                             collection=a["collection"],
                             submitted_by="policy")
        return acts

    def payload(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled and _ENABLED,
                    "ticks": self.ticks,
                    "interval_seconds": self.interval,
                    "thresholds": {
                        "cold_read_ops_per_second": self.cold_read_rate,
                        "full_fraction": self.full_fraction,
                        "hot_read_ops_per_second": self.hot_read_rate,
                        "cool_read_ops_per_second": self.cool_read_rate,
                        "warm_cache_hit_ratio": self.warm_cache_ratio,
                        "max_replicas": self.max_replicas,
                        "cooldown_seconds": self.cooldown,
                        "max_actions_per_tick":
                            self.max_actions_per_tick},
                    "actions": list(self.actions)}


# --------------------------------------------------------------------------
# volume-server side: the worker
# --------------------------------------------------------------------------


class JobWorker:
    """Claims one task at a time from the master and executes it
    against the local store, on the server's device. EC encode runs
    through the overlapped ingest pipeline (``encode_volume`` honors
    ``[pipeline]``); the other kinds reuse the server's gRPC servicer
    logic so job-driven and shell-driven maintenance share one
    implementation.

    While a task runs, the server's heartbeat snapshot carries it in
    ``Heartbeat.job_progress`` — that IS the lease renewal.

    ``finished`` keeps the last tasks this worker ran, newest last, each
    with its seconds and the kernel launches its thread made
    (``rs_cuda.thread_launches``): with two workers on one card, the
    card's counters alone cannot say whose launches they were.
    """

    #: Entries ``finished`` keeps.
    FINISHED_KEEP = 256

    def __init__(self, vs, poll_seconds: Optional[float] = None):
        self.vs = vs
        self.poll_seconds = (poll_seconds if poll_seconds is not None
                             else max(0.5, vs.pulse_seconds))
        self.claimed_total = 0
        self.completed_total = 0
        self.failed_total = 0
        self.finished: list[dict] = []
        self._current: Optional[dict] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------- lifecycle ----------------

    def start(self) -> "JobWorker":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"job-worker-{self.vs.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_seconds):
            if not _ENABLED or not self.vs.master_url:
                continue
            try:
                self._poll_once()
            except Exception as e:  # noqa: BLE001 — worker must not die
                glog.v(1, "jobs: worker poll failed: %s", e)

    def _poll_once(self) -> None:
        task = self._claim()
        if task:
            self._execute(task)

    # ---------------- master rpcs (HTTP, leader-proxied) ----------------

    def _claim(self) -> Optional[dict]:
        r = retry.http_request(
            f"http://{self.vs.master_url}/cluster/jobs/claim"
            f"?worker={self.vs.url}",
            method="POST", point="jobs.claim", timeout=5,
            use_breaker=False,
            retry_policy=retry.RetryPolicy(max_attempts=1))
        doc = json.loads(r.data or b"{}")
        return doc.get("task")

    def _report(self, task: dict, ok: bool, error: str) -> None:
        body = json.dumps({"worker": self.vs.url,
                           "taskId": task["taskId"],
                           "ok": ok, "error": error}).encode()
        try:
            retry.http_request(
                f"http://{self.vs.master_url}/cluster/jobs/complete",
                data=body, method="POST", point="jobs.complete",
                timeout=10, use_breaker=False)
        except Exception as e:  # noqa: BLE001 — lease expiry re-queues
            glog.warning("jobs: completion report for %s failed: %s",
                         task["taskId"], e)

    # ---------------- execution ----------------

    def set_fraction(self, f: float) -> None:
        with self._lock:
            if self._current is not None:
                self._current["fraction"] = min(1.0, max(0.0, f))

    def _execute(self, task: dict) -> None:
        with self._lock:
            self._current = dict(task, fraction=0.0)
            self.claimed_total += 1
        ok, err = True, ""
        launched = rs_cuda.thread_launches()
        t0 = time.perf_counter()
        try:
            glog.info("jobs: worker %s executing %s (%s volume %d)",
                      self.vs.url, task["taskId"], task["kind"],
                      task["volumeId"])
            self._dispatch(task)
        except Exception as e:  # noqa: BLE001 — report, don't die
            ok, err = False, f"{type(e).__name__}: {e}"
            glog.warning("jobs: %s failed on %s: %s", task["taskId"],
                         self.vs.url, err)
        finally:
            now = rs_cuda.thread_launches()
            with self._lock:
                self.completed_total += ok
                self.failed_total += not ok
                self.finished.append({
                    "taskId": task["taskId"], "kind": task["kind"],
                    "volumeId": task["volumeId"], "ok": ok,
                    "error": err,
                    "seconds": time.perf_counter() - t0,
                    "launches": {k: n - launched.get(k, 0)
                                 for k, n in now.items()
                                 if n != launched.get(k, 0)}})
                del self.finished[:-self.FINISHED_KEEP]
            self._report(task, ok, err)
            with self._lock:
                self._current = None

    def _dispatch(self, task: dict) -> None:
        kind = task["kind"]
        vid = int(task["volumeId"])
        col = task.get("collection", "")
        vs = self.vs
        if kind == "ec_encode":
            self._run_ec_encode(vid, col, task.get("params") or {})
        elif kind == "ec_rebuild":
            vs.servicer.VolumeEcShardsRebuild(
                volume_server_pb2.VolumeEcShardsRebuildRequest(
                    volume_id=vid, collection=col), None)
        elif kind == "vacuum":
            req = volume_server_pb2.VacuumVolumeCompactRequest(
                volume_id=vid, collection=col)
            vs.servicer.VacuumVolumeCompact(req, None)
            self.set_fraction(0.5)
            vs.servicer.VacuumVolumeCommit(
                volume_server_pb2.VacuumVolumeCommitRequest(
                    volume_id=vid, collection=col), None)
        elif kind == "replicate":
            src = task.get("source", "")
            if not src:
                raise JobError(f"replicate volume {vid}: no source "
                               f"replica available")
            vs.servicer.VolumeCopy(
                volume_server_pb2.VolumeCopyRequest(
                    volume_id=vid, collection=col,
                    source_data_node=src), None)
        elif kind == "replica_drop":
            vs.store.delete_volume(vid, col)
            vs.heartbeat_now()
        elif kind == "scrub":
            self._run_scrub(vid, col, task.get("params") or {})
        else:
            raise JobError(f"unknown task kind {kind!r}")

    def _run_ec_encode(self, vid: int, col: str, params: dict) -> None:
        """Distributed sweep's per-volume seal: freeze, encode through
        the overlapped pipeline on the server's device, mount the shards
        here. Spreading shards off this node stays a separate (balance)
        concern — exactly the generate step of the shell's ec.encode, so
        a single-host run produces byte-identical shard files."""
        vs = self.vs
        scheme = DEFAULT_SCHEME
        if params.get("data_shards") and params.get("parity_shards"):
            scheme = EcScheme(int(params["data_shards"]),
                              int(params["parity_shards"]))
        vs.store.mark_readonly(vid, col)
        vol = vs.store.get_volume(vid, col)
        vol.sync()
        self.set_fraction(0.1)
        mesh_spec = str(params.get("mesh") or "")
        if mesh_spec:
            # ec.encode -distributed -mesh dp,sp: the claiming worker
            # seals its volume over its own device slice. A spec that
            # cannot tile THIS worker's devices fails the task with the
            # MeshConfigError text in the job's failure log.
            from ..parallel import mesh as mesh_mod
            with mesh_mod.scoped(mesh_spec, device_type=vs.device.type):
                encode_mod.encode_volume(vol.base, scheme,
                                         device=vs.device)
        else:
            encode_mod.encode_volume(vol.base, scheme, device=vs.device)
        self.set_fraction(0.8)
        vs.store.mount_ec_shards(vid, list(range(scheme.total_shards)),
                                 col)
        if params.get("drop_source"):
            vs.store.delete_volume(vid, col)
        vs.heartbeat_now()

    def _run_scrub(self, vid: int, col: str, params: dict) -> None:
        """Paced integrity pass over whatever of volume ``vid`` lives
        here: live needles CRC-walked (corrupt ones repaired from a
        replica over ReadNeedleBlob), EC shards hash-verified against
        their sidecar baseline (corrupt ones quarantined + rebuilt from
        survivors on the server's device). One pacer spans both so the
        configured byte rate is a per-volume-task cap, not per-form."""
        from ..storage import scrubber
        from .volume_server import _scheme_from_vif

        vs = self.vs
        rate = params.get("rate_bytes_per_second")
        pacer = scrubber.RatePacer(
            int(rate) if rate is not None else None)
        did_any = False
        if vs.store.has_volume(vid, col):
            vol = vs.store.get_volume(vid, col)

            def _fetch(key: int):
                for peer in vs.replica_peers(vid, col):
                    try:
                        blob = vs.peer_stub(peer).ReadNeedleBlob(
                            volume_server_pb2.ReadNeedleBlobRequest(
                                volume_id=vid, collection=col,
                                needle_id=key))
                        if blob.needle_blob:
                            return bytes(blob.needle_blob)
                    except Exception as e:  # noqa: BLE001 — next peer
                        glog.v(1, "scrub: peer %s fetch of needle %d "
                               "failed: %s", peer, key, e)
                return None

            r = scrubber.scrub_volume(
                vol, pacer, fetch_record=_fetch,
                progress=lambda f: self.set_fraction(0.5 * f))
            glog.info("jobs: scrubbed volume %d [%s]: %s", vid, col,
                      {k: v for k, v in r.items() if k != "quarantined"})
            did_any = True
        mount = vs.store.ec_mounts.get((col, vid))
        if mount is not None:
            r = scrubber.scrub_ec(
                mount.base, _scheme_from_vif(mount.base), pacer,
                progress=lambda f: self.set_fraction(0.5 + 0.5 * f),
                device=vs.device)
            glog.info("jobs: scrubbed EC volume %d [%s]: %s", vid, col,
                      {k: v for k, v in r.items() if k != "quarantined"})
            did_any = True
        if not did_any:
            raise JobError(f"scrub volume {vid}: neither volume nor "
                           f"EC shards present on {vs.url}")
        self.set_fraction(1.0)

    # ---------------- heartbeat piggyback / views ----------------

    def progress_proto(self) -> master_pb2.JobProgress:
        with self._lock:
            jp = master_pb2.JobProgress(
                claimed_total=self.claimed_total,
                completed_total=self.completed_total)
            cur = self._current
            if cur is not None:
                jp.tasks.add(task_id=cur["taskId"], job_id=cur["jobId"],
                             kind=cur["kind"],
                             volume_id=int(cur["volumeId"]),
                             state="running",
                             fraction=float(cur.get("fraction", 0.0)))
            return jp

    def summary(self) -> dict:
        with self._lock:
            cur = self._current
            return {"claimed": self.claimed_total,
                    "completed": self.completed_total,
                    "failed": self.failed_total,
                    "poll_seconds": self.poll_seconds,
                    "current": (None if cur is None else
                                {"taskId": cur["taskId"],
                                 "kind": cur["kind"],
                                 "volumeId": cur["volumeId"],
                                 "fraction": round(
                                     cur.get("fraction", 0.0), 3)})}
