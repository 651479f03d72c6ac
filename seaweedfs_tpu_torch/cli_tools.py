"""Client-side CLI tools: upload, download, delete.

The port of ``seaweedfs_tpu/cli_tools.py``'s three client commands
(weed/command/{upload,download}.go; SURVEY.md §2 "CLI dispatcher"): thin
drivers over the operation client. Not ported yet (ROADMAP Queue 1):
``benchmark``, ``filer.copy`` and the ``-securityConfig`` flag.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .cluster import operation
from .cluster.wdclient import MasterClient


def run_upload(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="upload")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-ttl", default="")
    p.add_argument("files", nargs="+")
    args = p.parse_args(argv)
    master = MasterClient(args.master)
    results = []
    try:
        for f in args.files:
            data = Path(f).read_bytes()
            a = operation.assign(master, 1, args.collection,
                                 args.replication, args.ttl)
            operation.upload(a.url, a.fid, data, jwt=a.auth,
                             collection=args.collection)
            results.append({"file": f, "fid": a.fid, "size": len(data),
                            "url": f"{a.public_url}/{a.fid}"})
    finally:
        master.close()
    print(json.dumps(results, indent=2))
    return 0


def run_download(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="download")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-dir", default=".")
    p.add_argument("fids", nargs="+")
    args = p.parse_args(argv)
    master = MasterClient(args.master)
    try:
        for fid in args.fids:
            data = operation.download(master, fid,
                                      collection=args.collection)
            out = Path(args.dir) / fid.replace(",", "_")
            out.write_bytes(data)
            print(f"{fid} -> {out} ({len(data)} bytes)")
    finally:
        master.close()
    return 0


def run_delete(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="delete")
    p.add_argument("-master", default="127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("fids", nargs="+")
    args = p.parse_args(argv)
    master = MasterClient(args.master)
    try:
        for fid in args.fids:
            operation.delete(master, fid, collection=args.collection)
            print(f"deleted {fid}")
    finally:
        master.close()
    return 0
