"""Protobuf contracts + minimal gRPC stub plumbing.

The port's copy of ``seaweedfs_tpu/pb`` (weed/pb/): master.proto,
volume_server.proto and filer.proto subsets, their protoc-generated
``*_pb2`` modules (copied byte for byte), and a small declarative layer
that builds grpc client stubs and server registrations straight from the
pb2 message classes (what ``*_pb2_grpc.py`` would have contained, minus
the codegen).

The ``*_pb2`` modules register their files in protobuf's default
descriptor pool under the same names as the JAX package's copies
(``master.proto``, ...). The pool accepts a second registration only
when its serialized bytes are identical, and then both packages share
one message class each, so a process that imports both packages cannot
tell their messages apart with ``isinstance``: compatibility between the
packages is a matter of the wire, and the tests prove it there. If these
copies' descriptor bytes ever differ from the JAX package's, importing
both packages in one process fails.

:func:`generic_handler` runs every unary and server-streaming handler
under a ``grpc.<Method>`` trace span that continues the caller's
``x-seaweed-trace`` metadata.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import filer_pb2, master_pb2, volume_server_pb2  # noqa: F401

UNARY = "unary"
SERVER_STREAM = "server_stream"
BIDI_STREAM = "bidi_stream"


@dataclass(frozen=True)
class Method:
    name: str
    request_cls: type
    response_cls: type
    kind: str = UNARY


#: /master_pb.Seaweed/... method table (matches master.proto service).
MASTER_SERVICE = "master_pb.Seaweed"
MASTER_METHODS = [
    Method("SendHeartbeat", master_pb2.Heartbeat,
           master_pb2.HeartbeatResponse, BIDI_STREAM),
    Method("Assign", master_pb2.AssignRequest, master_pb2.AssignResponse),
    Method("LookupVolume", master_pb2.LookupVolumeRequest,
           master_pb2.LookupVolumeResponse),
    Method("LookupEcVolume", master_pb2.LookupEcVolumeRequest,
           master_pb2.LookupEcVolumeResponse),
    Method("VolumeList", master_pb2.VolumeListRequest,
           master_pb2.VolumeListResponse),
    Method("GetMasterConfiguration",
           master_pb2.GetMasterConfigurationRequest,
           master_pb2.GetMasterConfigurationResponse),
]

#: /volume_server_pb.VolumeServer/... method table.
VOLUME_SERVICE = "volume_server_pb.VolumeServer"
VOLUME_METHODS = [
    Method("AllocateVolume", volume_server_pb2.AllocateVolumeRequest,
           volume_server_pb2.AllocateVolumeResponse),
    Method("VolumeDelete", volume_server_pb2.VolumeDeleteRequest,
           volume_server_pb2.VolumeDeleteResponse),
    Method("VolumeMarkReadonly", volume_server_pb2.VolumeMarkReadonlyRequest,
           volume_server_pb2.VolumeMarkReadonlyResponse),
    Method("VolumeMarkWritable", volume_server_pb2.VolumeMarkWritableRequest,
           volume_server_pb2.VolumeMarkWritableResponse),
    Method("VolumeStatus", volume_server_pb2.VolumeStatusRequest,
           volume_server_pb2.VolumeStatusResponse),
    Method("VolumeConfigure", volume_server_pb2.VolumeConfigureRequest,
           volume_server_pb2.VolumeConfigureResponse),
    Method("VolumeMount", volume_server_pb2.VolumeMountRequest,
           volume_server_pb2.VolumeMountResponse),
    Method("VolumeUnmount", volume_server_pb2.VolumeUnmountRequest,
           volume_server_pb2.VolumeUnmountResponse),
    Method("CopyFile", volume_server_pb2.CopyFileRequest,
           volume_server_pb2.CopyFileResponse, SERVER_STREAM),
    Method("ReadNeedleBlob", volume_server_pb2.ReadNeedleBlobRequest,
           volume_server_pb2.ReadNeedleBlobResponse),
    Method("WriteNeedleBlob", volume_server_pb2.WriteNeedleBlobRequest,
           volume_server_pb2.WriteNeedleBlobResponse),
    Method("VolumeCopy", volume_server_pb2.VolumeCopyRequest,
           volume_server_pb2.VolumeCopyResponse),
    Method("VolumeEcShardsGenerate",
           volume_server_pb2.VolumeEcShardsGenerateRequest,
           volume_server_pb2.VolumeEcShardsGenerateResponse),
    Method("VolumeEcShardsRebuild",
           volume_server_pb2.VolumeEcShardsRebuildRequest,
           volume_server_pb2.VolumeEcShardsRebuildResponse),
    Method("VolumeEcShardsCopy",
           volume_server_pb2.VolumeEcShardsCopyRequest,
           volume_server_pb2.VolumeEcShardsCopyResponse),
    Method("VolumeEcShardsDelete",
           volume_server_pb2.VolumeEcShardsDeleteRequest,
           volume_server_pb2.VolumeEcShardsDeleteResponse),
    Method("VolumeEcShardsMount",
           volume_server_pb2.VolumeEcShardsMountRequest,
           volume_server_pb2.VolumeEcShardsMountResponse),
    Method("VolumeEcShardsUnmount",
           volume_server_pb2.VolumeEcShardsUnmountRequest,
           volume_server_pb2.VolumeEcShardsUnmountResponse),
    Method("VolumeEcShardRead",
           volume_server_pb2.VolumeEcShardReadRequest,
           volume_server_pb2.VolumeEcShardReadResponse, SERVER_STREAM),
    Method("VolumeEcShardsToVolume",
           volume_server_pb2.VolumeEcShardsToVolumeRequest,
           volume_server_pb2.VolumeEcShardsToVolumeResponse),
    Method("VolumeEcBlobDelete",
           volume_server_pb2.VolumeEcBlobDeleteRequest,
           volume_server_pb2.VolumeEcBlobDeleteResponse),
    Method("VacuumVolumeCheck",
           volume_server_pb2.VacuumVolumeCheckRequest,
           volume_server_pb2.VacuumVolumeCheckResponse),
    Method("VacuumVolumeCompact",
           volume_server_pb2.VacuumVolumeCompactRequest,
           volume_server_pb2.VacuumVolumeCompactResponse),
    Method("VacuumVolumeCommit",
           volume_server_pb2.VacuumVolumeCommitRequest,
           volume_server_pb2.VacuumVolumeCommitResponse),
    Method("VacuumVolumeCleanup",
           volume_server_pb2.VacuumVolumeCleanupRequest,
           volume_server_pb2.VacuumVolumeCleanupResponse),
    Method("VolumeTierMoveDatToRemote",
           volume_server_pb2.VolumeTierMoveDatToRemoteRequest,
           volume_server_pb2.VolumeTierMoveDatToRemoteResponse),
    Method("VolumeTierMoveDatFromRemote",
           volume_server_pb2.VolumeTierMoveDatFromRemoteRequest,
           volume_server_pb2.VolumeTierMoveDatFromRemoteResponse),
]


#: /filer_pb.SeaweedFiler/... method table (matches filer.proto).
FILER_SERVICE = "filer_pb.SeaweedFiler"
FILER_METHODS = [
    Method("LookupDirectoryEntry",
           filer_pb2.LookupDirectoryEntryRequest,
           filer_pb2.LookupDirectoryEntryResponse),
    Method("ListEntries", filer_pb2.ListEntriesRequest,
           filer_pb2.ListEntriesResponse, SERVER_STREAM),
    Method("CreateEntry", filer_pb2.CreateEntryRequest,
           filer_pb2.CreateEntryResponse),
    Method("UpdateEntry", filer_pb2.UpdateEntryRequest,
           filer_pb2.UpdateEntryResponse),
    Method("DeleteEntry", filer_pb2.DeleteEntryRequest,
           filer_pb2.DeleteEntryResponse),
    Method("AtomicRenameEntry", filer_pb2.AtomicRenameEntryRequest,
           filer_pb2.AtomicRenameEntryResponse),
    Method("SubscribeMetadata", filer_pb2.SubscribeMetadataRequest,
           filer_pb2.SubscribeMetadataResponse, SERVER_STREAM),
    Method("GetFilerConfiguration",
           filer_pb2.GetFilerConfigurationRequest,
           filer_pb2.GetFilerConfigurationResponse),
]


def generic_handler(service_name: str, methods: list[Method],
                    servicer) -> "grpc.GenericRpcHandler":
    """Build the server-side dispatch table for one service.

    ``servicer`` provides one method per Method.name; unary handlers take
    (request, context), streaming handlers follow grpc's usual shapes.
    """
    import grpc

    from ..util import tracing

    handlers: dict[str, object] = {}
    for m in methods:
        fn: Callable = getattr(servicer, m.name)
        if m.kind == UNARY:
            handlers[m.name] = grpc.unary_unary_rpc_method_handler(
                tracing.wrap_grpc_unary(fn, m.name),
                request_deserializer=m.request_cls.FromString,
                response_serializer=m.response_cls.SerializeToString)
        elif m.kind == SERVER_STREAM:
            handlers[m.name] = grpc.unary_stream_rpc_method_handler(
                tracing.wrap_grpc_stream(fn, m.name),
                request_deserializer=m.request_cls.FromString,
                response_serializer=m.response_cls.SerializeToString)
        elif m.kind == BIDI_STREAM:
            handlers[m.name] = grpc.stream_stream_rpc_method_handler(
                fn, request_deserializer=m.request_cls.FromString,
                response_serializer=m.response_cls.SerializeToString)
        else:  # pragma: no cover - table is static
            raise ValueError(m.kind)
    return grpc.method_handlers_generic_handler(service_name, handlers)


class Stub:
    """Client stub: one callable attribute per service method."""

    def __init__(self, channel, service_name: str, methods: list[Method]):
        for m in methods:
            path = f"/{service_name}/{m.name}"
            if m.kind == UNARY:
                call = channel.unary_unary(
                    path, request_serializer=m.request_cls.SerializeToString,
                    response_deserializer=m.response_cls.FromString)
            elif m.kind == SERVER_STREAM:
                call = channel.unary_stream(
                    path, request_serializer=m.request_cls.SerializeToString,
                    response_deserializer=m.response_cls.FromString)
            elif m.kind == BIDI_STREAM:
                call = channel.stream_stream(
                    path, request_serializer=m.request_cls.SerializeToString,
                    response_deserializer=m.response_cls.FromString)
            else:  # pragma: no cover
                raise ValueError(m.kind)
            setattr(self, m.name, call)


def master_stub(channel) -> Stub:
    return Stub(channel, MASTER_SERVICE, MASTER_METHODS)


def volume_stub(channel) -> Stub:
    return Stub(channel, VOLUME_SERVICE, VOLUME_METHODS)


def filer_stub(channel) -> Stub:
    return Stub(channel, FILER_SERVICE, FILER_METHODS)
