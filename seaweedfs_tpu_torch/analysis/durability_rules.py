"""SW9xx: durability rules — rename commit points must be persisted.

SW901 (warning)  a raw ``os.replace``/``os.rename`` call whose
                 enclosing function neither fsyncs the source before
                 the rename nor fsyncs the destination's parent
                 directory after it. A rename is the classic commit
                 point (vacuum's ``.cpd``→``.dat`` swap, a downloaded
                 ``.part`` moving into place, a ``.tmp`` sidecar
                 install) and on most filesystems it is NOT durable by
                 itself: the source bytes can be lost (rename-before-
                 data) and the rename itself lives in the directory,
                 which needs its own fsync. ``util/durability.py``'s
                 :func:`durable_replace` is the sanctioned idiom —
                 fsync source, replace, fsync parent dir — and that
                 module is the rule's one exemption.

The crash-recovery tests (tests/test_crashfs.py) prove the failure
mode this rule guards against: under crashfs replay, an un-fsynced
rename can be reordered ahead of its data writes, publishing a name
whose bytes never arrived.
"""

from __future__ import annotations

import ast
from typing import Optional

from .findings import Finding
from .model import ModuleInfo

#: The module allowed to call os.replace raw — it IS the idiom.
_SANCTIONED = ("util/durability.py",)

#: Call names that persist file CONTENTS (legal "fsync the source
#: before renaming" evidence).
_SRC_SYNCERS = ("fsync", "durable_replace", "drain", "barrier", "sync")

#: Call names that persist the DIRECTORY entry after the rename.
_DIR_SYNCERS = ("fsync", "fsync_dir", "durable_replace")

_SCOPE = (ast.FunctionDef, ast.AsyncFunctionDef)


def _callee_name(node: ast.Call, mi: ModuleInfo) -> Optional[str]:
    """Resolved short name of the callee: ``os.fsync`` -> "fsync" only
    when ``os`` really is the os module; ``durability.durable_replace``
    / a from-imported ``durable_replace`` / a method ``f.sync()`` all
    reduce to their attribute name."""
    fn = node.func
    if isinstance(fn, ast.Name):
        tgt = mi.from_imports.get(fn.id)
        return tgt[1] if tgt else fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _is_os_rename(node: ast.Call, mi: ModuleInfo) -> bool:
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        if mi.imports.get(fn.value.id, "") == "os" and \
                fn.attr in ("replace", "rename"):
            return True
    if isinstance(fn, ast.Name):
        tgt = mi.from_imports.get(fn.id)
        return tgt is not None and tgt[0] == "os" and \
            tgt[1] in ("replace", "rename")
    return False


def _check_function(mi: ModuleInfo, fn: ast.AST, qual: str,
                    out: list[Finding]) -> None:
    renames: list[ast.Call] = []
    src_sync_lines: list[int] = []
    dir_sync_lines: list[int] = []
    # walk the function body without descending into nested defs —
    # a nested function's barrier runs on ITS schedule, not ours
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, _SCOPE):
            continue
        stack.extend(ast.iter_child_nodes(node))
        if not isinstance(node, ast.Call):
            continue
        if _is_os_rename(node, mi):
            renames.append(node)
            continue
        name = _callee_name(node, mi)
        if name in _SRC_SYNCERS:
            src_sync_lines.append(node.lineno)
        if name in _DIR_SYNCERS:
            dir_sync_lines.append(node.lineno)

    for call in renames:
        missing = []
        if not any(ln <= call.lineno for ln in src_sync_lines):
            missing.append("fsync of the source before it")
        if not any(ln >= call.lineno for ln in dir_sync_lines):
            missing.append("fsync of the parent directory after it")
        if not missing:
            continue
        out.append(Finding(
            "SW901", "warning", mi.path, call.lineno, qual,
            f"rename commit point without {' or '.join(missing)} — "
            f"not durable across power loss; use "
            f"util/durability.durable_replace (or fsync_dir) so the "
            f"rename and the bytes it publishes both persist"))


def check_durability(modules: dict[str, ModuleInfo]) -> list[Finding]:
    out: list[Finding] = []
    for mi in modules.values():
        if mi.path.endswith(_SANCTIONED):
            continue
        # module-level statements count as one scope
        _check_function(
            mi, ast.Module(
                body=[n for n in mi.tree.body
                      if not isinstance(n, _SCOPE)], type_ignores=[]),
            f"{mi.name}:<module>", out)

        def _walk_defs(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _SCOPE):
                    q = f"{prefix}.{child.name}" if prefix \
                        else child.name
                    _check_function(mi, child, f"{mi.name}:{q}", out)
                    _walk_defs(child, q)
                elif isinstance(child, ast.ClassDef):
                    _walk_defs(child,
                               f"{prefix}.{child.name}" if prefix
                               else child.name)

        _walk_defs(mi.tree, "")
    return out
