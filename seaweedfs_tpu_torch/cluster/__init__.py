"""Cluster layer: the master, its clients and the volume-server data plane.

The port of ``seaweedfs_tpu/cluster`` (SURVEY.md §1 L2/L3), so far: the
master (``master.py`` over ``topology.py``, ``sequence.py`` and the
Raft-lite election of ``ha.py``), its clients (``wdclient.py``,
``operation.py``) and the volume server (``volume_server.py``), which
owns a Store, executes data-plane HTTP plus admin gRPC (the EC rpc
family) and streams its heartbeat to a master, and the maintenance
plane (``jobs.py``: the master's leased work-lists and the volume
servers' job workers), and the filer's server and client
(``filer_server.py``, ``filer_client.py``). The master also collects
the cluster's stitched traces (``util/tracing.TraceCollector``), the
telemetry registry and SLO engine (``telemetry.py``), the usage
registry (``usage.py``) and the jobs policy engine that turns their
signals into submitted jobs.
"""
