# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: volume_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13volume_server.proto\x12\x10volume_server_pb\"\x88\x01\n VolumeTierMoveDatToRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12 \n\x18\x64\x65stination_backend_name\x18\x03 \x01(\t\x12\x1b\n\x13keep_local_dat_file\x18\x04 \x01(\x08\"L\n!VolumeTierMoveDatToRemoteResponse\x12\x13\n\x0bmoved_bytes\x18\x01 \x01(\x04\x12\x12\n\nobject_url\x18\x02 \x01(\t\"K\n\"VolumeTierMoveDatFromRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\":\n#VolumeTierMoveDatFromRemoteResponse\x12\x13\n\x0bmoved_bytes\x18\x01 \x01(\x04\"A\n\x18VacuumVolumeCheckRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"2\n\x19VacuumVolumeCheckResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\"C\n\x1aVacuumVolumeCompactRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x1d\n\x1bVacuumVolumeCompactResponse\"B\n\x19VacuumVolumeCommitRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"1\n\x1aVacuumVolumeCommitResponse\x12\x13\n\x0bvolume_size\x18\x01 \x01(\x04\"C\n\x1aVacuumVolumeCleanupRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x1d\n\x1bVacuumVolumeCleanupResponse\"u\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0bpreallocate\x18\x05 \x01(\x03\"\x18\n\x16\x41llocateVolumeResponse\"<\n\x13VolumeDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x16\n\x14VolumeDeleteResponse\"B\n\x19VolumeMarkReadonlyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x1c\n\x1aVolumeMarkReadonlyResponse\"B\n\x19VolumeMarkWritableRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x1c\n\x1aVolumeMarkWritableResponse\"<\n\x13VolumeStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\";\n\x12VolumeMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x15\n\x13VolumeMountResponse\"=\n\x14VolumeUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\"\x17\n\x15VolumeUnmountResponse\"T\n\x16VolumeConfigureRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\"(\n\x17VolumeConfigureResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"y\n\x14VolumeStatusResponse\x12\x12\n\nhas_volume\x18\x01 \x01(\x08\x12\x10\n\x08\x64\x61t_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\x12\x11\n\tread_only\x18\x04 \x01(\x08\x12\x14\n\x0c\x65\x63_shard_ids\x18\x05 \x03(\r\"Q\n\x15ReadNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tneedle_id\x18\x03 \x01(\x04\"=\n\x16ReadNeedleBlobResponse\x12\x13\n\x0bneedle_blob\x18\x01 \x01(\x0c\x12\x0e\n\x06offset\x18\x02 \x01(\x04\"g\n\x16WriteNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tneedle_id\x18\x03 \x01(\x04\x12\x13\n\x0bneedle_blob\x18\x04 \x01(\x0c\")\n\x17WriteNeedleBlobResponse\x12\x0e\n\x06offset\x18\x01 \x01(\x04\"\x96\x01\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x0b\n\x03\x65xt\x18\x03 \x01(\t\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12$\n\x1cignore_source_file_not_found\x18\x05 \x01(\x08\x12\x14\n\x0cstart_offset\x18\x06 \x01(\x04\"(\n\x10\x43opyFileResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"T\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x18\n\x10source_data_node\x18\x03 \x01(\t\"/\n\x12VolumeCopyResponse\x12\x19\n\x11last_append_at_ns\x18\x01 \x01(\x04\"r\n\x1dVolumeEcShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x61ta_shards\x18\x03 \x01(\r\x12\x15\n\rparity_shards\x18\x04 \x01(\r\" \n\x1eVolumeEcShardsGenerateResponse\"E\n\x1cVolumeEcShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\":\n\x1dVolumeEcShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\"\xb4\x01\n\x19VolumeEcShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\x12\x15\n\rcopy_ecj_file\x18\x06 \x01(\x08\x12\x15\n\rcopy_vif_file\x18\x07 \x01(\x08\"\x1c\n\x1aVolumeEcShardsCopyResponse\"W\n\x1bVolumeEcShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1e\n\x1cVolumeEcShardsDeleteResponse\"V\n\x1aVolumeEcShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1d\n\x1bVolumeEcShardsMountResponse\"D\n\x1cVolumeEcShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x02 \x03(\r\"\x1f\n\x1dVolumeEcShardsUnmountResponse\"o\n\x18VolumeEcShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x03\x12\x10\n\x08\x66ile_key\x18\x05 \x01(\x04\"=\n\x19VolumeEcShardReadResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08\"F\n\x1dVolumeEcShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsToVolumeResponse\"e\n\x19VolumeEcBlobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"\x1c\n\x1aVolumeEcBlobDeleteResponse2\xf0\x17\n\x0cVolumeServer\x12\x65\n\x0e\x41llocateVolume\x12\'.volume_server_pb.AllocateVolumeRequest\x1a(.volume_server_pb.AllocateVolumeResponse\"\x00\x12_\n\x0cVolumeDelete\x12%.volume_server_pb.VolumeDeleteRequest\x1a&.volume_server_pb.VolumeDeleteResponse\"\x00\x12q\n\x12VolumeMarkReadonly\x12+.volume_server_pb.VolumeMarkReadonlyRequest\x1a,.volume_server_pb.VolumeMarkReadonlyResponse\"\x00\x12q\n\x12VolumeMarkWritable\x12+.volume_server_pb.VolumeMarkWritableRequest\x1a,.volume_server_pb.VolumeMarkWritableResponse\"\x00\x12_\n\x0cVolumeStatus\x12%.volume_server_pb.VolumeStatusRequest\x1a&.volume_server_pb.VolumeStatusResponse\"\x00\x12h\n\x0fVolumeConfigure\x12(.volume_server_pb.VolumeConfigureRequest\x1a).volume_server_pb.VolumeConfigureResponse\"\x00\x12\\\n\x0bVolumeMount\x12$.volume_server_pb.VolumeMountRequest\x1a%.volume_server_pb.VolumeMountResponse\"\x00\x12\x62\n\rVolumeUnmount\x12&.volume_server_pb.VolumeUnmountRequest\x1a\'.volume_server_pb.VolumeUnmountResponse\"\x00\x12U\n\x08\x43opyFile\x12!.volume_server_pb.CopyFileRequest\x1a\".volume_server_pb.CopyFileResponse\"\x00\x30\x01\x12Y\n\nVolumeCopy\x12#.volume_server_pb.VolumeCopyRequest\x1a$.volume_server_pb.VolumeCopyResponse\"\x00\x12}\n\x16VolumeEcShardsGenerate\x12/.volume_server_pb.VolumeEcShardsGenerateRequest\x1a\x30.volume_server_pb.VolumeEcShardsGenerateResponse\"\x00\x12z\n\x15VolumeEcShardsRebuild\x12..volume_server_pb.VolumeEcShardsRebuildRequest\x1a/.volume_server_pb.VolumeEcShardsRebuildResponse\"\x00\x12q\n\x12VolumeEcShardsCopy\x12+.volume_server_pb.VolumeEcShardsCopyRequest\x1a,.volume_server_pb.VolumeEcShardsCopyResponse\"\x00\x12w\n\x14VolumeEcShardsDelete\x12-.volume_server_pb.VolumeEcShardsDeleteRequest\x1a..volume_server_pb.VolumeEcShardsDeleteResponse\"\x00\x12t\n\x13VolumeEcShardsMount\x12,.volume_server_pb.VolumeEcShardsMountRequest\x1a-.volume_server_pb.VolumeEcShardsMountResponse\"\x00\x12z\n\x15VolumeEcShardsUnmount\x12..volume_server_pb.VolumeEcShardsUnmountRequest\x1a/.volume_server_pb.VolumeEcShardsUnmountResponse\"\x00\x12p\n\x11VolumeEcShardRead\x12*.volume_server_pb.VolumeEcShardReadRequest\x1a+.volume_server_pb.VolumeEcShardReadResponse\"\x00\x30\x01\x12}\n\x16VolumeEcShardsToVolume\x12/.volume_server_pb.VolumeEcShardsToVolumeRequest\x1a\x30.volume_server_pb.VolumeEcShardsToVolumeResponse\"\x00\x12q\n\x12VolumeEcBlobDelete\x12+.volume_server_pb.VolumeEcBlobDeleteRequest\x1a,.volume_server_pb.VolumeEcBlobDeleteResponse\"\x00\x12\x65\n\x0eReadNeedleBlob\x12\'.volume_server_pb.ReadNeedleBlobRequest\x1a(.volume_server_pb.ReadNeedleBlobResponse\"\x00\x12h\n\x0fWriteNeedleBlob\x12(.volume_server_pb.WriteNeedleBlobRequest\x1a).volume_server_pb.WriteNeedleBlobResponse\"\x00\x12n\n\x11VacuumVolumeCheck\x12*.volume_server_pb.VacuumVolumeCheckRequest\x1a+.volume_server_pb.VacuumVolumeCheckResponse\"\x00\x12t\n\x13VacuumVolumeCompact\x12,.volume_server_pb.VacuumVolumeCompactRequest\x1a-.volume_server_pb.VacuumVolumeCompactResponse\"\x00\x12q\n\x12VacuumVolumeCommit\x12+.volume_server_pb.VacuumVolumeCommitRequest\x1a,.volume_server_pb.VacuumVolumeCommitResponse\"\x00\x12t\n\x13VacuumVolumeCleanup\x12,.volume_server_pb.VacuumVolumeCleanupRequest\x1a-.volume_server_pb.VacuumVolumeCleanupResponse\"\x00\x12\x86\x01\n\x19VolumeTierMoveDatToRemote\x12\x32.volume_server_pb.VolumeTierMoveDatToRemoteRequest\x1a\x33.volume_server_pb.VolumeTierMoveDatToRemoteResponse\"\x00\x12\x8c\x01\n\x1bVolumeTierMoveDatFromRemote\x12\x34.volume_server_pb.VolumeTierMoveDatFromRemoteRequest\x1a\x35.volume_server_pb.VolumeTierMoveDatFromRemoteResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'volume_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_start=42
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_end=178
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_start=180
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_end=256
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_start=258
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_end=333
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_start=335
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_end=393
  _VACUUMVOLUMECHECKREQUEST._serialized_start=395
  _VACUUMVOLUMECHECKREQUEST._serialized_end=460
  _VACUUMVOLUMECHECKRESPONSE._serialized_start=462
  _VACUUMVOLUMECHECKRESPONSE._serialized_end=512
  _VACUUMVOLUMECOMPACTREQUEST._serialized_start=514
  _VACUUMVOLUMECOMPACTREQUEST._serialized_end=581
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_start=583
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_end=612
  _VACUUMVOLUMECOMMITREQUEST._serialized_start=614
  _VACUUMVOLUMECOMMITREQUEST._serialized_end=680
  _VACUUMVOLUMECOMMITRESPONSE._serialized_start=682
  _VACUUMVOLUMECOMMITRESPONSE._serialized_end=731
  _VACUUMVOLUMECLEANUPREQUEST._serialized_start=733
  _VACUUMVOLUMECLEANUPREQUEST._serialized_end=800
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_start=802
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_end=831
  _ALLOCATEVOLUMEREQUEST._serialized_start=833
  _ALLOCATEVOLUMEREQUEST._serialized_end=950
  _ALLOCATEVOLUMERESPONSE._serialized_start=952
  _ALLOCATEVOLUMERESPONSE._serialized_end=976
  _VOLUMEDELETEREQUEST._serialized_start=978
  _VOLUMEDELETEREQUEST._serialized_end=1038
  _VOLUMEDELETERESPONSE._serialized_start=1040
  _VOLUMEDELETERESPONSE._serialized_end=1062
  _VOLUMEMARKREADONLYREQUEST._serialized_start=1064
  _VOLUMEMARKREADONLYREQUEST._serialized_end=1130
  _VOLUMEMARKREADONLYRESPONSE._serialized_start=1132
  _VOLUMEMARKREADONLYRESPONSE._serialized_end=1160
  _VOLUMEMARKWRITABLEREQUEST._serialized_start=1162
  _VOLUMEMARKWRITABLEREQUEST._serialized_end=1228
  _VOLUMEMARKWRITABLERESPONSE._serialized_start=1230
  _VOLUMEMARKWRITABLERESPONSE._serialized_end=1258
  _VOLUMESTATUSREQUEST._serialized_start=1260
  _VOLUMESTATUSREQUEST._serialized_end=1320
  _VOLUMEMOUNTREQUEST._serialized_start=1322
  _VOLUMEMOUNTREQUEST._serialized_end=1381
  _VOLUMEMOUNTRESPONSE._serialized_start=1383
  _VOLUMEMOUNTRESPONSE._serialized_end=1404
  _VOLUMEUNMOUNTREQUEST._serialized_start=1406
  _VOLUMEUNMOUNTREQUEST._serialized_end=1467
  _VOLUMEUNMOUNTRESPONSE._serialized_start=1469
  _VOLUMEUNMOUNTRESPONSE._serialized_end=1492
  _VOLUMECONFIGUREREQUEST._serialized_start=1494
  _VOLUMECONFIGUREREQUEST._serialized_end=1578
  _VOLUMECONFIGURERESPONSE._serialized_start=1580
  _VOLUMECONFIGURERESPONSE._serialized_end=1620
  _VOLUMESTATUSRESPONSE._serialized_start=1622
  _VOLUMESTATUSRESPONSE._serialized_end=1743
  _READNEEDLEBLOBREQUEST._serialized_start=1745
  _READNEEDLEBLOBREQUEST._serialized_end=1826
  _READNEEDLEBLOBRESPONSE._serialized_start=1828
  _READNEEDLEBLOBRESPONSE._serialized_end=1889
  _WRITENEEDLEBLOBREQUEST._serialized_start=1891
  _WRITENEEDLEBLOBREQUEST._serialized_end=1994
  _WRITENEEDLEBLOBRESPONSE._serialized_start=1996
  _WRITENEEDLEBLOBRESPONSE._serialized_end=2037
  _COPYFILEREQUEST._serialized_start=2040
  _COPYFILEREQUEST._serialized_end=2190
  _COPYFILERESPONSE._serialized_start=2192
  _COPYFILERESPONSE._serialized_end=2232
  _VOLUMECOPYREQUEST._serialized_start=2234
  _VOLUMECOPYREQUEST._serialized_end=2318
  _VOLUMECOPYRESPONSE._serialized_start=2320
  _VOLUMECOPYRESPONSE._serialized_end=2367
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_start=2369
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_end=2483
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_start=2485
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_end=2517
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_start=2519
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_end=2588
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_start=2590
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_end=2648
  _VOLUMEECSHARDSCOPYREQUEST._serialized_start=2651
  _VOLUMEECSHARDSCOPYREQUEST._serialized_end=2831
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_start=2833
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_end=2861
  _VOLUMEECSHARDSDELETEREQUEST._serialized_start=2863
  _VOLUMEECSHARDSDELETEREQUEST._serialized_end=2950
  _VOLUMEECSHARDSDELETERESPONSE._serialized_start=2952
  _VOLUMEECSHARDSDELETERESPONSE._serialized_end=2982
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_start=2984
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_end=3070
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_start=3072
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_end=3101
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_start=3103
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_end=3171
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_start=3173
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_end=3204
  _VOLUMEECSHARDREADREQUEST._serialized_start=3206
  _VOLUMEECSHARDREADREQUEST._serialized_end=3317
  _VOLUMEECSHARDREADRESPONSE._serialized_start=3319
  _VOLUMEECSHARDREADRESPONSE._serialized_end=3380
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_start=3382
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_end=3452
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_start=3454
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_end=3486
  _VOLUMEECBLOBDELETEREQUEST._serialized_start=3488
  _VOLUMEECBLOBDELETEREQUEST._serialized_end=3589
  _VOLUMEECBLOBDELETERESPONSE._serialized_start=3591
  _VOLUMEECBLOBDELETERESPONSE._serialized_end=3619
  _VOLUMESERVER._serialized_start=3622
  _VOLUMESERVER._serialized_end=6678
# @@protoc_insertion_point(module_scope)
