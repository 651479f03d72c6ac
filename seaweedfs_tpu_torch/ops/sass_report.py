"""Instruction counts of the built GF(2^8) kernels, read from their SASS.

    python -m seaweedfs_tpu_torch.ops.sass_report

Builds the kernel library if needed (``rs_cuda.library``; needs ``nvcc``
and ``cuobjdump`` under CUDA_HOME or on PATH, no card), disassembles it
with ``cuobjdump -sass`` and prints, for each kernel instance, its total
instruction count and every loop (a backward branch): its length in
instructions, the count of each opcode in it, and how many of its
instructions are predicated. The innermost loop that loads from global
memory is the loop over input shards: its length is the instructions one
lane spends per input shard on one 32-byte position. Also prints each
instance's registers and spills from the build's ``-Xptxas -v`` output.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from . import rs_cuda

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                   r"\s*([^;]*);")
_FUNC = re.compile(r"Function : (\S+)")
_INSTANCE = re.compile(r"(gf_(?:transpose|swar)_kernel)ILi(\d+)E")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / name)


def instance(mangled: str) -> str:
    m = _INSTANCE.search(mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def parse(sass: str) -> dict:
    """{function: [(address, predicated, opcode, operands), ...]}"""
    funcs, cur = {}, None
    for line in sass.splitlines():
        f = _FUNC.search(line)
        if f:
            cur = funcs.setdefault(f.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), bool(m.group(2)),
                        m.group(3), m.group(4).strip()))
    return funcs


def loops(insns: list) -> list:
    """(start, end, instructions in between) for each backward branch."""
    index = {addr: k for k, (addr, *_rest) in enumerate(insns)}
    out = []
    for k, (addr, _pred, op, args) in enumerate(insns):
        if op.startswith("BRA"):
            t = re.search(r"0x([0-9a-f]+)", args)
            if t and int(t.group(1), 16) <= addr:
                start = index.get(int(t.group(1), 16))
                if start is not None:
                    out.append((start, k, insns[start:k + 1]))
    return out


def report(sass: str) -> str:
    lines = []
    for name, insns in sorted(parse(sass).items(),
                              key=lambda kv: instance(kv[0])):
        lines.append(f"{instance(name)}: {len(insns)} instructions")
        for start, end, body in loops(insns):
            ops = collections.Counter(op.split(".")[0] for _a, _p, op, _x
                                      in body)
            pred = sum(p for _a, p, _o, _x in body)
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common())
            lines.append(f"  loop [{start}..{end}]: {len(body)} "
                         f"instructions, {pred} predicated: {top}")
    return "\n".join(lines)


def main() -> int:
    lib = rs_cuda._build()
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                         check=True, capture_output=True, text=True).stdout
    print(report(out))
    for line in rs_cuda.BUILD_LOG.splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print(line.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
