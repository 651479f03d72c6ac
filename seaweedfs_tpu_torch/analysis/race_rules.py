"""SW8xx: thread-role shared-state race rules.

Consumes the thread-role model (threads.py): which roles reach each
function, the guaranteed lockset on every path into it, and every
shared-state access with its lexically-held locks. The Eraser framing:
an attribute is race-free when the intersection of locksets over all
its cross-role accesses is non-empty; these rules flag the static
shadow of that invariant.

SW801 (error)   instance/module attribute written from >=2 thread
                roles (or one multi-instance role) with an empty
                lockset intersection across the writes.
SW802 (warning) compound read-modify-write (``x += 1``,
                check-then-set) on a shared attribute outside any
                lock — atomic-looking code that is two bytecodes.
SW803 (warning) unguarded dict/list/set mutation on a shared
                collection (CPython's GIL keeps single ops from
                corrupting, but iterate-while-mutate and
                check-then-act still break).
SW804 (error)   publish-before-init: ``self`` handed to a thread /
                queue inside ``__init__`` (``.start()``, ``.put(self)``)
                with attributes still assigned afterwards — the new
                thread can observe a half-built object.

Lifecycle methods (``__init__``, ``close``, ``stop``, ``join``, ...)
are happens-before windows: their writes never count toward the
>=2-roles test (see threads.steady_roles). Deliberate designs get an
inline pragma with justification; everything else is a bug.
"""

from __future__ import annotations

from .findings import Finding
from .threads import Access, ThreadModel, build_thread_model, steady_roles

#: Attributes that are synchronization primitives or documented
#: single-writer fields; assigning a Lock/Event is how you make
#: things safe, not a race.
_LOCKY_ATTR = ("lock", "cond", "event", "sem")


def _locky(attr: str) -> bool:
    low = attr.lower()
    return any(t in low for t in _LOCKY_ATTR)


def _qual(func_key: str) -> str:
    return func_key


def _site(acc: Access) -> str:
    return f"{acc.path}:{acc.line}"


def _roles_str(roles) -> str:
    return "{" + ", ".join(sorted(roles)) + "}"


def _is_shared(model: ThreadModel, writes: list[Access]) -> tuple:
    """(shared?, union of steady roles) for one (owner, attr) group.

    Shared means: steady-state writes from >=2 distinct roles, or from
    one role that is multi-instance (two threads of the same role race
    each other just fine).
    """
    union: set = set()
    for a in writes:
        union |= steady_roles(model, a)
    multi = union & model.multi_roles
    return (len(union) >= 2 or bool(multi)), union


def check_races(fp) -> list[Finding]:
    model = build_thread_model(fp)
    return rules_over_model(model)


def rules_over_model(model: ThreadModel) -> list[Finding]:
    out: list[Finding] = []

    # group steady-state accesses per (owner, attr)
    groups: dict[tuple, list[Access]] = {}
    for a in model.accesses:
        groups.setdefault((a.owner, a.attr), []).append(a)

    sw801_attrs: set[tuple] = set()

    for (owner, attr), accs in sorted(groups.items()):
        if _locky(attr):
            continue
        writes = [a for a in accs if a.kind in ("write", "rmw")
                  and steady_roles(model, a)]
        mutates = [a for a in accs if a.kind == "mutate"
                   and steady_roles(model, a)]

        # ---- SW801: cross-role writes, empty lockset intersection ----
        if writes:
            shared, union = _is_shared(model, writes)
            if shared:
                common = None
                for a in writes:
                    eff = model.effective_lockset(a)
                    common = eff if common is None else (common & eff)
                if not common:
                    first = min(writes, key=lambda a: (a.path, a.line))
                    others = sorted(
                        {_site(a) for a in writes} - {_site(first)})
                    sites = ", ".join(others[:4])
                    more = "" if len(others) <= 4 else \
                        f" (+{len(others) - 4} more)"
                    out.append(Finding(
                        "SW801", "error", first.path, first.line,
                        _qual(first.func),
                        f"attribute '{attr}' of {owner} is written from "
                        f"thread roles {_roles_str(union)} with no "
                        f"common lock; other write sites: "
                        f"{sites or 'same line'}{more}",
                        extra={"anchors": sorted(
                            {a.line for a in writes
                             if a.path == first.path})}))
                    sw801_attrs.add((owner, attr))

        # ---- SW802: unguarded compound RMW on a shared attribute ----
        if (owner, attr) not in sw801_attrs:
            owner_roles = model.owner_roles(owner)
            shared_owner = len(owner_roles) >= 2 or \
                bool(owner_roles & model.multi_roles)
            if shared_owner:
                for a in writes:
                    if a.kind != "rmw" and not a.compound:
                        continue
                    if model.effective_lockset(a):
                        continue
                    what = "check-then-set" if a.compound else \
                        "read-modify-write"
                    out.append(Finding(
                        "SW802", "warning", a.path, a.line,
                        _qual(a.func),
                        f"compound {what} on shared attribute "
                        f"'{attr}' of {owner} outside any lock "
                        f"(reachable roles "
                        f"{_roles_str(steady_roles(model, a))}); "
                        f"two threads interleave between the read "
                        f"and the write"))

        # ---- SW803: unguarded container mutation on shared owner ----
        if mutates and (owner, attr) in model.containers:
            owner_roles = model.owner_roles(owner)
            shared_owner = len(owner_roles) >= 2 or \
                bool(owner_roles & model.multi_roles)
            if shared_owner:
                bad = [a for a in mutates
                       if not model.effective_lockset(a)]
                # one finding per attr, anchored at the first bad site
                if bad and len(
                        {r for a in mutates
                         for r in steady_roles(model, a)}) >= 1:
                    roles_here = set()
                    for a in bad:
                        roles_here |= steady_roles(model, a)
                    if len(roles_here) >= 2 or \
                            roles_here & model.multi_roles or \
                            len(owner_roles) >= 2:
                        first = min(bad, key=lambda a: (a.path, a.line))
                        kind = model.containers[(owner, attr)]
                        sites = sorted({_site(a) for a in bad})
                        out.append(Finding(
                            "SW803", "warning", first.path, first.line,
                            _qual(first.func),
                            f"unguarded {kind} mutation "
                            f"({first.detail}) on shared collection "
                            f"'{attr}' of {owner} (owner reachable "
                            f"from roles {_roles_str(owner_roles)}; "
                            f"{len(sites)} unguarded site(s))",
                            extra={"anchors": sorted(
                                {a.line for a in bad
                                 if a.path == first.path})}))

    # ---- SW804: publish-before-init ----
    for init_key, (pub_line, desc) in sorted(model.publishes.items()):
        late = [a for a in model.accesses
                if a.func == init_key and a.in_init
                and a.kind in ("write", "rmw")
                and a.line > pub_line]
        if not late:
            continue
        first = min(late, key=lambda a: a.line)
        attrs = ", ".join(sorted({a.attr for a in late})[:5])
        out.append(Finding(
            "SW804", "error", first.path, pub_line, _qual(init_key),
            f"object published before construction completes: "
            f"{desc} at line {pub_line}, but attribute(s) {attrs} "
            f"assigned after (first at line {first.line}); the "
            f"spawned thread can observe a half-built object",
            extra={"anchors": sorted({a.line for a in late})}))

    return out
