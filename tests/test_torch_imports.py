"""The port (seaweedfs_tpu_torch) and chip_smoke.py import neither JAX nor
anything of the JAX package (seaweedfs_tpu), and the port's entry points
never fall back to the CPU when asked for the card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import seaweedfs_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    seaweedfs_tpu_torch.__path__, "seaweedfs_tpu_torch.")]
for name in names:
    __import__(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "seaweedfs_tpu" or m.startswith("seaweedfs_tpu.")
             or m == "jax" and sys.modules[m] is not None
             or m.startswith("jax.") or m.startswith("jaxlib"))
print(len(names), "modules;", "bad:", bad)
new = {"seaweedfs_tpu_torch.pipeline.batch", "seaweedfs_tpu_torch.pipeline.pipe",
       "seaweedfs_tpu_torch.ops.rs_torch", "seaweedfs_tpu_torch.__main__",
       "seaweedfs_tpu_torch.shell", "seaweedfs_tpu_torch.shell.cli",
       "seaweedfs_tpu_torch.shell.commands",
       "seaweedfs_tpu_torch.storage.backend",
       "seaweedfs_tpu_torch.storage.store",
       "seaweedfs_tpu_torch.storage.volume",
       "seaweedfs_tpu_torch.util.durability",
       "seaweedfs_tpu_torch.parallel", "seaweedfs_tpu_torch.parallel.mesh",
       "seaweedfs_tpu_torch.parallel.dryrun",
       "seaweedfs_tpu_torch.util.config", "seaweedfs_tpu_torch.util.stats",
       "seaweedfs_tpu_torch.pipeline.flight",
       "seaweedfs_tpu_torch.storage.needle_map_native",
       "seaweedfs_tpu_torch.storage.needle_map_sqlite",
       "seaweedfs_tpu_torch.storage.vacuum",
       "seaweedfs_tpu_torch.storage.scrubber",
       "seaweedfs_tpu_torch.util.crashfs",
       "seaweedfs_tpu_torch.pb", "seaweedfs_tpu_torch.pb.master_pb2",
       "seaweedfs_tpu_torch.pb.volume_server_pb2",
       "seaweedfs_tpu_torch.pb.filer_pb2",
       "seaweedfs_tpu_torch.cluster",
       "seaweedfs_tpu_torch.cluster.volume_server",
       "seaweedfs_tpu_torch.util.glog", "seaweedfs_tpu_torch.util.security",
       "seaweedfs_tpu_torch.util.tls", "seaweedfs_tpu_torch.util.httpserver",
       "seaweedfs_tpu_torch.util.retry"}
print("missing:", sorted(new - set(names)))
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "bad: []" in out.stdout
    # every module of the slices so far was imported, the shell, Store,
    # Volume engine, the multi-device split, the config loader, the
    # flight recorder, the needle maps, vacuum, the scrubber, the crash
    # harness, the pb copies, the volume server and its wire utilities
    # among them
    assert int(out.stdout.split()[0]) >= 62
    assert "missing: []" in out.stdout


def test_entry_points_refuse_the_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None means the card")
    from seaweedfs_tpu_torch.pipeline import batch, decode, encode, rebuild
    from seaweedfs_tpu_torch.storage import volume
    base = tmp_path / "v"
    volume.write_synthetic_volume(base, 4096, avg_size=512)
    for call in (lambda: encode.encode_volume(base),
                 lambda: rebuild.rebuild_ec_files(base),
                 lambda: decode.decode_volume(base),
                 lambda: batch.encode_volumes([base]),
                 lambda: batch.encode_many([np.zeros(100, np.uint8)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # nothing was written on the CPU instead
    assert not list(tmp_path.glob("v.ec*"))
