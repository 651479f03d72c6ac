"""SW5xx — pooled-buffer lifetime & async-copy rules (dataflow clients).

The bug class the pipeline's writer once shipped: the overlapped pipeline
hands out views of HostBufferPool slabs, recycles the slab when a
BatchToken fires, and ``np.ascontiguousarray`` silently returns the
*input itself* when it is already contiguous — so a "copy" handed to
the async writeback pool was really a view of a buffer the reader was
about to refill. These rules run over the value-flow events
(dataflow.py) and catch that shape statically:

- SW501 (error): a value derived from a pooled-buffer acquire escapes
  to an asynchronous sink (``queue.put`` / ``.submit`` without a
  BatchToken argument) *and* the same buffer is released in the same
  function — the consumer races the recycle. Interprocedural: the
  escape or the release may happen inside a resolved callee.
- SW502 (error): a pooled buffer (or a view of it) is read after the
  buffer was released — straight-line use-after-free. Events pair
  only when their branch paths are prefix-comparable, so an ``if``
  arm's release never pairs with the ``else`` arm's use.
- SW503 (error, the torch form): a host buffer is written (a subscript
  store, an in-place method such as ``fill_``/``copy_``/``zero_``,
  ``out=``, ``buf += x``), refilled (``readinto``/``np.copyto``) or
  released to its pool after an asynchronous copy from or into it
  (``.copy_(..., non_blocking=True)``, ``.to(..., non_blocking=True)``)
  with no ``Event.synchronize()``, ``stream.synchronize()`` or
  ``torch.cuda.synchronize()`` (nor a resolved project call that makes
  one) between the copy and the write: the copy engine may still be
  reading or writing those pages. The buffer is followed through the
  dataflow's views, so releasing the pooled slab that a copied
  ``torch.from_numpy(view)`` was cut from pairs with the copy
  (ckpt/store.py ``_place_block`` synchronizes every copy's event
  before its release, and reads as clean). It replaces the JAX
  package's read-after-donation rule: the port donates no buffers.

The runtime counterpart is util/bufcheck.py (SEAWEEDFS_TORCH_BUFCHECK=1):
generation-tagged poisoned recycles catch at test time what these
rules cannot prove statically.
"""

from __future__ import annotations

from .dataflow import FlowProject
from .findings import Finding

#: Sinks where the consumer outlives the producing statement.
_ASYNC_SINKS = {"queue.put", "submit"}


def _comparable(a: tuple, b: tuple) -> bool:
    """True when one branch path prefixes the other (same control
    path), so event A can actually precede event B at runtime."""
    n = min(len(a), len(b))
    return a[:n] == b[:n]


def check_buffers(fp: FlowProject) -> list[Finding]:
    findings: list[Finding] = []
    for ff in fp.flows.values():
        releases = [ev for ev in ff.events if ev.kind == "release"
                    and any(t[0] == "pool" for t in ev.tokens)]
        escapes = [ev for ev in ff.events if ev.kind == "escape"
                   and any(t[0] == "pool" for t in ev.tokens)]
        uses = [ev for ev in ff.events if ev.kind == "use"]

        # ---- SW501: pooled view escapes an async sink + same-function
        # release → the sink's consumer races the recycle ----
        for esc in escapes:
            if esc.sink not in _ASYNC_SINKS or esc.protected:
                continue
            esc_roots = {t for t in esc.tokens if t[0] == "pool"}
            for rel in releases:
                if not (esc_roots & rel.tokens):
                    continue
                if not _comparable(esc.branch, rel.branch):
                    continue
                acq_line = min(t[1] for t in (esc_roots & rel.tokens))
                via = f" ({esc.detail})" if esc.detail else ""
                findings.append(Finding(
                    "SW501", "error", ff.path, esc.line, ff.key,
                    f"view of pooled buffer (acquired line {acq_line}) "
                    f"escapes to async {esc.sink}{via} without a "
                    f"BatchToken, and the buffer is released at line "
                    f"{rel.line} — the write can read a recycled "
                    f"buffer (the recycled-slab race); copy the data "
                    f"(flatten()) or gate the release on a token",
                    extra={"anchors": (rel.line,)}))
                break

        # ---- SW502: use (or escape) of a pooled view after its
        # buffer was released in the same straight-line region ----
        for rel in releases:
            rel_roots = {t for t in rel.tokens if t[0] == "pool"}
            for ev in (*uses, *escapes):
                if ev.line <= rel.line:
                    continue
                if not _comparable(ev.branch, rel.branch):
                    continue
                hit = rel_roots & {t for t in ev.tokens
                                   if t[0] == "pool"}
                if not hit:
                    continue
                acq_line = min(t[1] for t in hit)
                what = (f"escapes via {ev.sink}" if ev.kind == "escape"
                        else f"is read ({ev.detail})")
                findings.append(Finding(
                    "SW502", "error", ff.path, ev.line, ff.key,
                    f"pooled buffer (acquired line {acq_line}) "
                    f"released at line {rel.line} but a view of it "
                    f"{what} afterwards — use-after-release",
                    extra={"anchors": (rel.line,)}))
                break  # one finding per release site is enough

        # ---- SW503: host buffer touched under an async copy ----
        for ev in ff.events:
            if ev.kind != "async_hazard":
                continue
            findings.append(Finding(
                "SW503", "error", ff.path, ev.line, ff.key,
                f"host buffer {ev.detail} — synchronize the copy's "
                f"Event (or its stream, or torch.cuda.synchronize()) "
                f"before writing or releasing the buffer",
                extra={}))
    return findings
