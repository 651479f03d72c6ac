# -*- coding: utf-8 -*-
# Generated by scripts/gen_master_pb2.py.  DO NOT EDIT!
# source: master.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cmaster.proto\x12\tmaster_pb"\xbb\x03\n\tHeartbeat\x12\n\n\x02ip\x18\x01 \x01(\t\x12\x0c\n\x04port\x18\x02 \x01(\r\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\x18\n\x10max_volume_count\x18\x04 \x01(\r\x12\x14\n\x0cmax_file_key\x18\x05 \x01(\x04\x12\x13\n\x0bdata_center\x18\x06 \x01(\t\x12\x0c\n\x04rack\x18\x07 \x01(\t\x124\n\x07volumes\x18\x08 \x03(\x0b2#.master_pb.VolumeInformationMessage\x12=\n\tec_shards\x18\t \x03(\x0b2*.master_pb.VolumeEcShardInformationMessage\x12\x16\n\x0ehas_no_volumes\x18\n \x01(\x08\x12\x18\n\x10has_no_ec_shards\x18\x0b \x01(\x08\x12/\n\ttelemetry\x18\x0c \x01(\x0b2\x1c.master_pb.TelemetrySnapshot\x12\'\n\x05usage\x18\r \x01(\x0b2\x18.master_pb.UsageSnapshot\x12,\n\x0cjob_progress\x18\x0e \x01(\x0b2\x16.master_pb.JobProgress"W\n\x11HeartbeatResponse\x12\x19\n\x11volume_size_limit\x18\x01 \x01(\x04\x12\x0e\n\x06leader\x18\x02 \x01(\t\x12\x17\n\x0fmetrics_address\x18\x03 \x01(\t"\xf6\x01\n\x18VolumeInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x0c\n\x04size\x18\x02 \x01(\x04\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x12\n\nfile_count\x18\x04 \x01(\x04\x12\x14\n\x0cdelete_count\x18\x05 \x01(\x04\x12\x1a\n\x12deleted_byte_count\x18\x06 \x01(\x04\x12\x11\n\tread_only\x18\x07 \x01(\x08\x12\x19\n\x11replica_placement\x18\x08 \x01(\r\x12\x0f\n\x07version\x18\t \x01(\r\x12\x0b\n\x03ttl\x18\n \x01(\r\x12\x1a\n\x12modified_at_second\x18\x0b \x01(\x04"X\n\x1fVolumeEcShardInformationMessage\x12\n\n\x02id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x15\n\rec_index_bits\x18\x03 \x01(\r"w\n\rAssignRequest\x12\r\n\x05count\x18\x01 \x01(\x04\x12\x13\n\x0breplication\x18\x02 \x01(\t\x12\x12\n\ncollection\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x13\n\x0bdata_center\x18\x05 \x01(\t\x12\x0c\n\x04rack\x18\x06 \x01(\t"j\n\x0eAssignResponse\x12\x0b\n\x03fid\x18\x01 \x01(\t\x12\x0b\n\x03url\x18\x02 \x01(\t\x12\x12\n\npublic_url\x18\x03 \x01(\t\x12\r\n\x05count\x18\x04 \x01(\x04\x12\r\n\x05error\x18\x05 \x01(\t\x12\x0c\n\x04auth\x18\x06 \x01(\t"=\n\x13LookupVolumeRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\t\x12\x12\n\ncollection\x18\x02 \x01(\t";\n\x08Location\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x0e\n\x06shards\x18\x03 \x03(\r"\xc3\x01\n\x14LookupVolumeResponse\x12M\n\x13volume_id_locations\x18\x01 \x03(\x0b20.master_pb.LookupVolumeResponse.VolumeIdLocation\x1a\\\n\x10VolumeIdLocation\x12\x11\n\tvolume_id\x18\x01 \x01(\t\x12&\n\tlocations\x18\x02 \x03(\x0b2\x13.master_pb.Location\x12\r\n\x05error\x18\x03 \x01(\t"*\n\x15LookupEcVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r"\xcb\x01\n\x16LookupEcVolumeResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12O\n\x12shard_id_locations\x18\x02 \x03(\x0b23.master_pb.LookupEcVolumeResponse.EcShardIdLocation\x1aM\n\x11EcShardIdLocation\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12&\n\tlocations\x18\x02 \x03(\x0b2\x13.master_pb.Location"\x13\n\x11VolumeListRequest"b\n\x12VolumeListResponse\x12.\n\rtopology_info\x18\x01 \x01(\x0b2\x17.master_pb.TopologyInfo\x12\x1c\n\x14volume_size_limit_mb\x18\x02 \x01(\x04"P\n\x0cTopologyInfo\x12\n\n\x02id\x18\x01 \x01(\t\x124\n\x11data_center_infos\x18\x02 \x03(\x0b2\x19.master_pb.DataCenterInfo"E\n\x0eDataCenterInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\'\n\nrack_infos\x18\x02 \x03(\x0b2\x13.master_pb.RackInfo"H\n\x08RackInfo\x12\n\n\x02id\x18\x01 \x01(\t\x120\n\x0fdata_node_infos\x18\x02 \x03(\x0b2\x17.master_pb.DataNodeInfo"\x81\x02\n\x0cDataNodeInfo\x12\n\n\x02id\x18\x01 \x01(\t\x12\x14\n\x0cvolume_count\x18\x02 \x01(\x04\x12\x18\n\x10max_volume_count\x18\x03 \x01(\x04\x12\x19\n\x11free_volume_count\x18\x04 \x01(\x04\x12\x1b\n\x13active_volume_count\x18\x05 \x01(\x04\x129\n\x0cvolume_infos\x18\x06 \x03(\x0b2#.master_pb.VolumeInformationMessage\x12B\n\x0eec_shard_infos\x18\x07 \x03(\x0b2*.master_pb.VolumeEcShardInformationMessage"\x1f\n\x1dGetMasterConfigurationRequest"\x8b\x01\n\x1eGetMasterConfigurationResponse\x12\x17\n\x0fmetrics_address\x18\x01 \x01(\t\x12 \n\x18metrics_interval_seconds\x18\x02 \x01(\r\x12\x19\n\x11volume_size_limit\x18\x03 \x01(\x04\x12\x13\n\x0bjwt_enabled\x18\x04 \x01(\x08"w\n\rDigestMessage\x12\x16\n\x0ecentroid_means\x18\x01 \x03(\x01\x12\x18\n\x10centroid_weights\x18\x02 \x03(\x01\x12\x0b\n\x03min\x18\x03 \x01(\x01\x12\x0b\n\x03max\x18\x04 \x01(\x01\x12\r\n\x05count\x18\x05 \x01(\x04\x12\x0b\n\x03sum\x18\x06 \x01(\x01"\xb4\x02\n\x0eVolumeHotStats\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08read_ops\x18\x03 \x01(\x04\x12\x11\n\twrite_ops\x18\x04 \x01(\x04\x12\x12\n\nread_bytes\x18\x05 \x01(\x04\x12\x13\n\x0bwrite_bytes\x18\x06 \x01(\x04\x12\x12\n\ncache_hits\x18\x07 \x01(\x04\x12\x14\n\x0ccache_misses\x18\x08 \x01(\x04\x12\x12\n\nec_decodes\x18\t \x01(\x04\x12\x0e\n\x06errors\x18\n \x01(\x04\x12.\n\x0cread_latency\x18\x0b \x01(\x0b2\x18.master_pb.DigestMessage\x12/\n\rwrite_latency\x18\x0c \x01(\x0b2\x18.master_pb.DigestMessage"0\n\x0eHotStackSample\x12\r\n\x05stack\x18\x01 \x01(\t\x12\x0f\n\x07samples\x18\x02 \x01(\x04"\x81\x01\n\x11TelemetrySnapshot\x12\x11\n\twindow_ns\x18\x01 \x01(\x04\x12*\n\x07volumes\x18\x02 \x03(\x0b2\x19.master_pb.VolumeHotStats\x12-\n\nhot_stacks\x18\x03 \x03(\x0b2\x19.master_pb.HotStackSample"V\n\tTopKEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05count\x18\x02 \x01(\x04\x12\r\n\x05error\x18\x03 \x01(\x04\x12\x0e\n\x06tenant\x18\x04 \x01(\t\x12\x0e\n\x06volume\x18\x05 \x01(\r"\x9f\x01\n\x0bTenantUsage\x12\x0e\n\x06tenant\x18\x01 \x01(\t\x12\x0e\n\x06bucket\x18\x02 \x01(\t\x12\x10\n\x08requests\x18\x03 \x01(\x04\x12\x10\n\x08bytes_in\x18\x04 \x01(\x04\x12\x11\n\tbytes_out\x18\x05 \x01(\x04\x12\x0e\n\x06errors\x18\x06 \x01(\x04\x12)\n\x07latency\x18\x07 \x01(\x0b2\x18.master_pb.DigestMessage"\xb1\x01\n\rUsageSnapshot\x12\x11\n\twindow_ns\x18\x01 \x01(\x04\x12\x11\n\tcomponent\x18\x02 \x01(\t\x12\'\n\x07tenants\x18\x03 \x03(\x0b2\x16.master_pb.TenantUsage\x12&\n\x08top_keys\x18\x04 \x03(\x0b2\x14.master_pb.TopKEntry\x12\x12\n\ntopk_total\x18\x05 \x01(\x04\x12\x15\n\rtopk_capacity\x18\x06 \x01(\r"\x83\x01\n\x0fJobTaskProgress\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0e\n\x06job_id\x18\x02 \x01(\t\x12\x0c\n\x04kind\x18\x03 \x01(\t\x12\x11\n\tvolume_id\x18\x04 \x01(\r\x12\r\n\x05state\x18\x05 \x01(\t\x12\x10\n\x08fraction\x18\x06 \x01(\x01\x12\r\n\x05error\x18\x07 \x01(\t"h\n\x0bJobProgress\x12)\n\x05tasks\x18\x01 \x03(\x0b2\x1a.master_pb.JobTaskProgress\x12\x15\n\rclaimed_total\x18\x02 \x01(\x04\x12\x17\n\x0fcompleted_total\x18\x03 \x01(\x042\xff\x03\n\x07Seaweed\x12I\n\rSendHeartbeat\x12\x14.master_pb.Heartbeat\x1a\x1c.master_pb.HeartbeatResponse"\x00(\x010\x01\x12?\n\x06Assign\x12\x18.master_pb.AssignRequest\x1a\x19.master_pb.AssignResponse"\x00\x12Q\n\x0cLookupVolume\x12\x1e.master_pb.LookupVolumeRequest\x1a\x1f.master_pb.LookupVolumeResponse"\x00\x12W\n\x0eLookupEcVolume\x12 .master_pb.LookupEcVolumeRequest\x1a!.master_pb.LookupEcVolumeResponse"\x00\x12K\n\nVolumeList\x12\x1c.master_pb.VolumeListRequest\x1a\x1d.master_pb.VolumeListResponse"\x00\x12o\n\x16GetMasterConfiguration\x12(.master_pb.GetMasterConfigurationRequest\x1a).master_pb.GetMasterConfigurationResponse"\x00b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'master_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEARTBEAT._serialized_start=28
  _HEARTBEAT._serialized_end=471
  _HEARTBEATRESPONSE._serialized_start=473
  _HEARTBEATRESPONSE._serialized_end=560
  _VOLUMEINFORMATIONMESSAGE._serialized_start=563
  _VOLUMEINFORMATIONMESSAGE._serialized_end=809
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_start=811
  _VOLUMEECSHARDINFORMATIONMESSAGE._serialized_end=899
  _ASSIGNREQUEST._serialized_start=901
  _ASSIGNREQUEST._serialized_end=1020
  _ASSIGNRESPONSE._serialized_start=1022
  _ASSIGNRESPONSE._serialized_end=1128
  _LOOKUPVOLUMEREQUEST._serialized_start=1130
  _LOOKUPVOLUMEREQUEST._serialized_end=1191
  _LOCATION._serialized_start=1193
  _LOCATION._serialized_end=1252
  _LOOKUPVOLUMERESPONSE._serialized_start=1255
  _LOOKUPVOLUMERESPONSE._serialized_end=1450
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_start=1358
  _LOOKUPVOLUMERESPONSE_VOLUMEIDLOCATION._serialized_end=1450
  _LOOKUPECVOLUMEREQUEST._serialized_start=1452
  _LOOKUPECVOLUMEREQUEST._serialized_end=1494
  _LOOKUPECVOLUMERESPONSE._serialized_start=1497
  _LOOKUPECVOLUMERESPONSE._serialized_end=1700
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_start=1623
  _LOOKUPECVOLUMERESPONSE_ECSHARDIDLOCATION._serialized_end=1700
  _VOLUMELISTREQUEST._serialized_start=1702
  _VOLUMELISTREQUEST._serialized_end=1721
  _VOLUMELISTRESPONSE._serialized_start=1723
  _VOLUMELISTRESPONSE._serialized_end=1821
  _TOPOLOGYINFO._serialized_start=1823
  _TOPOLOGYINFO._serialized_end=1903
  _DATACENTERINFO._serialized_start=1905
  _DATACENTERINFO._serialized_end=1974
  _RACKINFO._serialized_start=1976
  _RACKINFO._serialized_end=2048
  _DATANODEINFO._serialized_start=2051
  _DATANODEINFO._serialized_end=2308
  _GETMASTERCONFIGURATIONREQUEST._serialized_start=2310
  _GETMASTERCONFIGURATIONREQUEST._serialized_end=2341
  _GETMASTERCONFIGURATIONRESPONSE._serialized_start=2344
  _GETMASTERCONFIGURATIONRESPONSE._serialized_end=2483
  _DIGESTMESSAGE._serialized_start=2485
  _DIGESTMESSAGE._serialized_end=2604
  _VOLUMEHOTSTATS._serialized_start=2607
  _VOLUMEHOTSTATS._serialized_end=2915
  _HOTSTACKSAMPLE._serialized_start=2917
  _HOTSTACKSAMPLE._serialized_end=2965
  _TELEMETRYSNAPSHOT._serialized_start=2968
  _TELEMETRYSNAPSHOT._serialized_end=3097
  _TOPKENTRY._serialized_start=3099
  _TOPKENTRY._serialized_end=3185
  _TENANTUSAGE._serialized_start=3188
  _TENANTUSAGE._serialized_end=3347
  _USAGESNAPSHOT._serialized_start=3350
  _USAGESNAPSHOT._serialized_end=3527
  _JOBTASKPROGRESS._serialized_start=3530
  _JOBTASKPROGRESS._serialized_end=3661
  _JOBPROGRESS._serialized_start=3663
  _JOBPROGRESS._serialized_end=3767
  _SEAWEED._serialized_start=3770
  _SEAWEED._serialized_end=4281
# @@protoc_insertion_point(module_scope)
