"""Cluster layer: the volume-server data plane.

The port of ``seaweedfs_tpu/cluster`` (SURVEY.md §1 L2/L3), so far its
volume server (``volume_server.py``): it owns a Store and executes
data-plane HTTP plus admin gRPC (the EC rpc family), and streams its
heartbeat to a master. Not ported yet (ROADMAP Queue 1): the master,
``wdclient`` / ``operation``, the filer and the jobs plane; the port's
volume servers join the JAX package's master until the port has one.
"""
