"""Twin runs of the JAX package's linter (``seaweedfs_tpu.analysis``) and
the port's (``seaweedfs_tpu_torch.analysis``) for the mirrored lint tests.

A snippet is linted by both packages, with ``seaweedfs_tpu`` in its paths
and source text spelled as each package's own name. Both must give the
same findings — rule, severity, line, qualname and message, with the
package name masked — and the caller gets the findings of the package
under test. The one message wording the port changed (the SW501 race's
name in parentheses) is masked too."""

from __future__ import annotations

import importlib
import re
import textwrap

PKGS = ("jax", "port")
ROOT = {"jax": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}

_NAME_RE = re.compile(r"\bseaweedfs_tpu(?:_torch)?\b")
_SW501_NAME_RE = re.compile(r" \(the [^)]*race\)")


def module(pkg: str, name: str = ""):
    """``<package>.analysis[.<name>]`` of ``pkg``."""
    return importlib.import_module(
        f"{ROOT[pkg]}.analysis" + (f".{name}" if name else ""))


def to_pkg(text: str, pkg: str) -> str:
    """``text`` with the JAX package's name spelled as ``pkg``'s."""
    return re.sub(r"\bseaweedfs_tpu\b", ROOT[pkg], text)


def mask(text: str) -> str:
    return _SW501_NAME_RE.sub("", _NAME_RE.sub("<pkg>", text))


def key(f) -> tuple:
    return (f.rule, f.severity, mask(f.path), f.line, mask(f.qualname),
            mask(f.message))


def sources_of(files_or_src, path="pkg/mod.py") -> dict[str, str]:
    if isinstance(files_or_src, str):
        files_or_src = {path: files_or_src}
    return {p: textwrap.dedent(s) for p, s in files_or_src.items()}


def twin(sources: dict[str, str], pkg: str, **kw) -> list:
    """Both packages' ``analyze_sources`` on ``sources``; asserts equal
    findings and returns ``pkg``'s."""
    got = {}
    for p in PKGS:
        got[p] = module(p).analyze_sources(
            {to_pkg(path, p): to_pkg(src, p)
             for path, src in sources.items()}, **kw)
    assert sorted(map(key, got["jax"])) == sorted(map(key, got["port"]))
    return got[pkg]
