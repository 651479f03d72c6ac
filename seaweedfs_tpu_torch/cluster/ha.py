"""Master high availability: leader election + control-state replication.

The port of ``seaweedfs_tpu/cluster/ha.py``, whole, over the port's
``util/retry``. Its wire (``/raft/vote`` and ``/raft/heartbeat`` JSON)
is the reference's, so port and JAX masters can share one election.

Plays the role of weed/server/raft_server.go (SURVEY.md §2 row "Raft",
§3.4): among N masters exactly one becomes leader, the leader's
topology-critical state (max volume id, needle-sequence high-water mark)
is persisted and replicated so a failover never reissues ids, and
followers point clients and volume servers at the leader.

The protocol is a deliberately small Raft subset — the reference's raft
(goraft-era) also rode the masters' HTTP plane:

* terms + randomized election timeouts + majority votes (Raft §5.2);
* a vote is only granted to a candidate whose replicated state is at
  least as new as the voter's (the log-up-to-date rule collapsed onto
  the state snapshot, since the whole "log" here is two counters);
* the leader heartbeats its full control state to every peer; followers
  apply and persist it (snapshot replication instead of log entries —
  the state is tiny and idempotent, so shipping it whole is simpler and
  loses nothing);
* terms and state are fsynced to ``<meta_dir>/master.raft.json`` before
  they are acted on.

Transport is HTTP JSON on the masters' existing HTTP servers
(``/raft/vote``, ``/raft/heartbeat``) — no new dependency, trivially
debuggable, and matches the reference's own choice of transport. With no
peers configured the node is a standing leader and none of the machinery
runs (single-master clusters behave exactly as before).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from pathlib import Path
from typing import Callable, Optional

from ..util import glog, retry

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class NotLeaderError(RuntimeError):
    """Raised by leader-only operations on a follower; carries the
    current leader's url (or '' when unknown mid-election)."""

    def __init__(self, leader: str):
        super().__init__(f"not the leader; leader is {leader or 'unknown'}")
        self.leader = leader


class RaftNode:
    """One master's election state machine.

    ``self_url`` / ``peers`` are the masters' HTTP urls ("ip:port").
    ``snapshot_state()`` must return the leader's replicable dict;
    ``apply_state(d)`` installs a replicated dict on a follower. Both
    must be cheap — they run on heartbeat cadence.
    """

    def __init__(self, self_url: str, peers: list[str],
                 state_path: Optional[str | Path] = None,
                 snapshot_state: Optional[Callable[[], dict]] = None,
                 apply_state: Optional[Callable[[dict], None]] = None,
                 heartbeat_interval: float = 0.15,
                 election_timeout: tuple[float, float] = (0.45, 0.9),
                 rpc_timeout: float = 0.4):
        self.self_url = self_url
        self.peers = [p for p in peers if p and p != self_url]
        self.quorum = (len(self.peers) + 1) // 2 + 1
        self.state_path = Path(state_path) if state_path else None
        self.snapshot_state = snapshot_state or (lambda: {})
        self.apply_state = apply_state or (lambda d: None)
        self.heartbeat_interval = heartbeat_interval
        self.election_timeout = election_timeout
        self.rpc_timeout = rpc_timeout

        self._lock = threading.RLock()
        self.role = LEADER if not self.peers else FOLLOWER
        self.term = 0
        self.voted_for: Optional[str] = None
        self.leader: str = self_url if not self.peers else ""
        self._last_heard = time.monotonic()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._last_persisted: Optional[dict] = None
        self._load()

    # ------------- persistence -------------

    def _load(self) -> None:
        if self.state_path and self.state_path.exists():
            try:
                d = json.loads(self.state_path.read_text())
                self.term = int(d.get("term", 0))
                self.voted_for = d.get("voted_for") or None
                state = d.get("state") or {}
                if state:
                    self.apply_state(state)
            except (ValueError, OSError) as e:
                glog.warning("raft %s: unreadable state file: %s",
                             self.self_url, e)

    def _persist(self) -> None:
        if not self.state_path:
            return
        # Serialized on the node lock: replicate_now() runs off the
        # master's request threads while vote/heartbeat handlers persist
        # under the lock — two writers on one .tmp would tear the state
        # file and a torn file degrades to term 0 on restart. Skipped
        # when nothing changed (steady-state heartbeats would otherwise
        # fsync ~7x/s forever on every follower).
        with self._lock:
            payload = {"term": self.term, "voted_for": self.voted_for,
                       "state": self.snapshot_state()}
            if payload == self._last_persisted:
                return
            tmp = self.state_path.with_suffix(".tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
                f.flush()
                os.fsync(f.fileno())
            tmp.replace(self.state_path)
            self._last_persisted = payload

    # ------------- lifecycle -------------

    def start(self) -> "RaftNode":
        if not self.peers:
            return self  # standing leader, nothing to run
        t = threading.Thread(target=self._ticker, daemon=True,
                             name=f"raft-{self.self_url}")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)

    @property
    def is_leader(self) -> bool:
        return self.role == LEADER

    # ------------- state-version ordering -------------

    def _state_version(self) -> list:
        """Total order over replicated state for the vote freshness rule
        (max volume id, then sequence high-water)."""
        s = self.snapshot_state()
        return [int(s.get("max_volume_id", 0)),
                int(s.get("sequence_next", 0))]

    # ------------- timers -------------

    def _ticker(self) -> None:
        timeout = random.uniform(*self.election_timeout)
        while not self._stop.wait(0.03):
            with self._lock:
                role = self.role
                since = time.monotonic() - self._last_heard
            if role == LEADER:
                self._broadcast_heartbeat()
                self._stop.wait(self.heartbeat_interval)
            elif since >= timeout:
                self._run_election()
                timeout = random.uniform(*self.election_timeout)

    # ------------- election -------------

    def _run_election(self) -> None:
        with self._lock:
            self.term += 1
            self.role = CANDIDATE
            self.voted_for = self.self_url
            self.leader = ""
            term = self.term
            self._last_heard = time.monotonic()
            self._persist()
        glog.v(1, "raft %s: starting election for term %d",
               self.self_url, term)
        votes = 1
        req = {"term": term, "candidate": self.self_url,
               "state_version": self._state_version()}
        results: list[dict] = []
        threads = []
        for p in self.peers:
            t = threading.Thread(
                target=lambda p=p: results.append(
                    self._post(p, "/raft/vote", req)), daemon=True)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + self.rpc_timeout
        for t in threads:
            t.join(timeout=max(0, deadline - time.monotonic()))
        for r in results:
            if not r:
                continue
            if r.get("term", 0) > term:
                self._step_down(r["term"])
                return
            if r.get("granted"):
                votes += 1
        with self._lock:
            if self.role != CANDIDATE or self.term != term:
                return  # a heartbeat already converted us
            if votes >= self.quorum:
                self.role = LEADER
                self.leader = self.self_url
                glog.info("raft %s: won term %d with %d/%d votes",
                          self.self_url, term, votes,
                          len(self.peers) + 1)
            else:
                self.role = FOLLOWER  # retry after a fresh timeout
        if self.is_leader:
            self._broadcast_heartbeat()

    def _step_down(self, term: int) -> None:
        with self._lock:
            if term > self.term:
                self.term = term
                self.voted_for = None
                self._persist()
            if self.role != FOLLOWER:
                glog.info("raft %s: stepping down (term %d)",
                          self.self_url, term)
            self.role = FOLLOWER
            # A deposed leader must stop advertising itself: clients
            # redirected to a stale self-reference would spin. Unknown
            # until the new leader's first heartbeat names it.
            if self.leader == self.self_url:
                self.leader = ""
            self._last_heard = time.monotonic()

    # ------------- leader side -------------

    def _broadcast_heartbeat(self) -> None:
        req = {"term": self.term, "leader": self.self_url,
               "state": self.snapshot_state()}
        # Parallel: a black-holed peer must not delay the heartbeat to
        # live followers past their election timeout (serial posts with
        # an rpc_timeout stall would trigger spurious elections).
        results: list[Optional[dict]] = []
        threads = []
        for p in self.peers:
            t = threading.Thread(
                target=lambda p=p: results.append(
                    self._post(p, "/raft/heartbeat", req)), daemon=True)
            t.start()
            threads.append(t)
        deadline = time.monotonic() + self.rpc_timeout
        for t in threads:
            t.join(timeout=max(0, deadline - time.monotonic()))
        for r in results:
            if r and r.get("term", 0) > self.term:
                self._step_down(r["term"])
                return

    def replicate_now(self) -> None:
        """Best-effort synchronous state push (called after the leader
        mutates control state, e.g. a volume grow, so a crash right
        after the mutation doesn't strand the newest ids)."""
        if self.is_leader and self.peers:
            self._persist()
            self._broadcast_heartbeat()
        else:
            self._persist()

    # ------------- rpc handlers (wired into the master's HTTP server) --

    def handle_vote(self, req: dict) -> dict:
        with self._lock:
            term = int(req.get("term", 0))
            if term > self.term:
                self.term = term
                self.voted_for = None
                if self.role != FOLLOWER:
                    self.role = FOLLOWER
                if self.leader == self.self_url:
                    self.leader = ""
            granted = (
                term == self.term
                and self.voted_for in (None, req.get("candidate"))
                and list(req.get("state_version", []))
                >= self._state_version())
            if granted:
                self.voted_for = req.get("candidate")
                self._last_heard = time.monotonic()
            self._persist()
            return {"term": self.term, "granted": granted}

    def handle_heartbeat(self, req: dict) -> dict:
        term = int(req.get("term", 0))
        with self._lock:
            if term < self.term:
                return {"term": self.term}
            if term > self.term:
                self.term = term
                self.voted_for = None
            self.role = FOLLOWER
            self.leader = req.get("leader", "")
            self._last_heard = time.monotonic()
        state = req.get("state") or {}
        if state:
            self.apply_state(state)
        with self._lock:
            self._persist()
        return {"term": self.term}

    # ------------- transport -------------

    def _post(self, peer: str, path: str, payload: dict) -> Optional[dict]:
        # Raft owns its own timing: election timeouts ARE the retry
        # loop, so exactly one attempt, no breaker — a retry layer here
        # would stretch heartbeat intervals and destabilize elections.
        try:
            body = json.dumps(payload).encode()
            with retry.deadline_scope(self.rpc_timeout):
                f = retry.http_request(
                    f"http://{peer}{path}", data=body, method="POST",
                    headers={"Content-Type": "application/json"},
                    point="master.rpc", timeout=self.rpc_timeout,
                    retry_policy=retry.RetryPolicy(max_attempts=1),
                    use_breaker=False)
            return json.loads(f.data or b"{}")
        except Exception:  # noqa: BLE001 — unreachable peer = no vote
            return None
