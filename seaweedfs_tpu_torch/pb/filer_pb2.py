# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66iler.proto\x12\x08\x66iler_pb\"Z\n\tFileChunk\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0c\n\x04size\x18\x03 \x01(\x04\x12\x10\n\x08mtime_ns\x18\x04 \x01(\x03\x12\x0c\n\x04\x65tag\x18\x05 \x01(\t\"\xb7\x01\n\x0e\x46useAttributes\x12\x11\n\tfile_size\x18\x01 \x01(\x04\x12\r\n\x05mtime\x18\x02 \x01(\x03\x12\x11\n\tfile_mode\x18\x03 \x01(\r\x12\x0b\n\x03uid\x18\x04 \x01(\r\x12\x0b\n\x03gid\x18\x05 \x01(\r\x12\x0e\n\x06\x63rtime\x18\x06 \x01(\x03\x12\x0c\n\x04mime\x18\x07 \x01(\t\x12\x13\n\x0breplication\x18\x08 \x01(\t\x12\x12\n\ncollection\x18\t \x01(\t\x12\x0f\n\x07ttl_sec\x18\n \x01(\x05\"\xe0\x01\n\x05\x45ntry\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x14\n\x0cis_directory\x18\x02 \x01(\x08\x12#\n\x06\x63hunks\x18\x03 \x03(\x0b\x32\x13.filer_pb.FileChunk\x12,\n\nattributes\x18\x04 \x01(\x0b\x32\x18.filer_pb.FuseAttributes\x12/\n\x08\x65xtended\x18\x05 \x03(\x0b\x32\x1d.filer_pb.Entry.ExtendedEntry\x1a/\n\rExtendedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c:\x02\x38\x01\">\n\x1bLookupDirectoryEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\">\n\x1cLookupDirectoryEntryResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"\x82\x01\n\x12ListEntriesRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0e\n\x06prefix\x18\x02 \x01(\t\x12\x1c\n\x14start_from_file_name\x18\x03 \x01(\t\x12\x1c\n\x14inclusive_start_from\x18\x04 \x01(\x08\x12\r\n\x05limit\x18\x05 \x01(\r\"5\n\x13ListEntriesResponse\x12\x1e\n\x05\x65ntry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\"k\n\x12\x43reateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x0e\n\x06o_excl\x18\x03 \x01(\x08\x12\x12\n\nsignatures\x18\x04 \x03(\x05\"$\n\x13\x43reateEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"[\n\x12UpdateEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x1e\n\x05\x65ntry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x12\n\nsignatures\x18\x03 \x03(\x05\"\x15\n\x13UpdateEntryResponse\"w\n\x12\x44\x65leteEntryRequest\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x16\n\x0eis_delete_data\x18\x03 \x01(\x08\x12\x14\n\x0cis_recursive\x18\x04 \x01(\x08\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"$\n\x13\x44\x65leteEntryResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"\x80\x01\n\x18\x41tomicRenameEntryRequest\x12\x15\n\rold_directory\x18\x01 \x01(\t\x12\x10\n\x08old_name\x18\x02 \x01(\t\x12\x15\n\rnew_directory\x18\x03 \x01(\t\x12\x10\n\x08new_name\x18\x04 \x01(\t\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"\x1b\n\x19\x41tomicRenameEntryResponse\"j\n\x18SubscribeMetadataRequest\x12\x13\n\x0b\x63lient_name\x18\x01 \x01(\t\x12\x13\n\x0bpath_prefix\x18\x02 \x01(\t\x12\x10\n\x08since_ns\x18\x03 \x01(\x03\x12\x12\n\nsignatures\x18\x04 \x03(\x05\"v\n\x19SubscribeMetadataResponse\x12\x11\n\tdirectory\x18\x01 \x01(\t\x12\x37\n\x12\x65vent_notification\x18\x02 \x01(\x0b\x32\x1b.filer_pb.EventNotification\x12\r\n\x05ts_ns\x18\x03 \x01(\x03\"\x9f\x01\n\x11\x45ventNotification\x12\"\n\told_entry\x18\x01 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\"\n\tnew_entry\x18\x02 \x01(\x0b\x32\x0f.filer_pb.Entry\x12\x15\n\rdelete_chunks\x18\x03 \x01(\x08\x12\x17\n\x0fnew_parent_path\x18\x04 \x01(\t\x12\x12\n\nsignatures\x18\x05 \x03(\x05\"\x1e\n\x1cGetFilerConfigurationRequest\"o\n\x1dGetFilerConfigurationResponse\x12\x11\n\tsignature\x18\x01 \x01(\x05\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x12\n\nstarted_ns\x18\x04 \x01(\x03\x32\xdf\x05\n\x0cSeaweedFiler\x12g\n\x14LookupDirectoryEntry\x12%.filer_pb.LookupDirectoryEntryRequest\x1a&.filer_pb.LookupDirectoryEntryResponse\"\x00\x12N\n\x0bListEntries\x12\x1c.filer_pb.ListEntriesRequest\x1a\x1d.filer_pb.ListEntriesResponse\"\x00\x30\x01\x12L\n\x0b\x43reateEntry\x12\x1c.filer_pb.CreateEntryRequest\x1a\x1d.filer_pb.CreateEntryResponse\"\x00\x12L\n\x0bUpdateEntry\x12\x1c.filer_pb.UpdateEntryRequest\x1a\x1d.filer_pb.UpdateEntryResponse\"\x00\x12L\n\x0b\x44\x65leteEntry\x12\x1c.filer_pb.DeleteEntryRequest\x1a\x1d.filer_pb.DeleteEntryResponse\"\x00\x12^\n\x11\x41tomicRenameEntry\x12\".filer_pb.AtomicRenameEntryRequest\x1a#.filer_pb.AtomicRenameEntryResponse\"\x00\x12`\n\x11SubscribeMetadata\x12\".filer_pb.SubscribeMetadataRequest\x1a#.filer_pb.SubscribeMetadataResponse\"\x00\x30\x01\x12j\n\x15GetFilerConfiguration\x12&.filer_pb.GetFilerConfigurationRequest\x1a\'.filer_pb.GetFilerConfigurationResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filer_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ENTRY_EXTENDEDENTRY._options = None
  _ENTRY_EXTENDEDENTRY._serialized_options = b'8\001'
  _FILECHUNK._serialized_start=25
  _FILECHUNK._serialized_end=115
  _FUSEATTRIBUTES._serialized_start=118
  _FUSEATTRIBUTES._serialized_end=301
  _ENTRY._serialized_start=304
  _ENTRY._serialized_end=528
  _ENTRY_EXTENDEDENTRY._serialized_start=481
  _ENTRY_EXTENDEDENTRY._serialized_end=528
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_start=530
  _LOOKUPDIRECTORYENTRYREQUEST._serialized_end=592
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_start=594
  _LOOKUPDIRECTORYENTRYRESPONSE._serialized_end=656
  _LISTENTRIESREQUEST._serialized_start=659
  _LISTENTRIESREQUEST._serialized_end=789
  _LISTENTRIESRESPONSE._serialized_start=791
  _LISTENTRIESRESPONSE._serialized_end=844
  _CREATEENTRYREQUEST._serialized_start=846
  _CREATEENTRYREQUEST._serialized_end=953
  _CREATEENTRYRESPONSE._serialized_start=955
  _CREATEENTRYRESPONSE._serialized_end=991
  _UPDATEENTRYREQUEST._serialized_start=993
  _UPDATEENTRYREQUEST._serialized_end=1084
  _UPDATEENTRYRESPONSE._serialized_start=1086
  _UPDATEENTRYRESPONSE._serialized_end=1107
  _DELETEENTRYREQUEST._serialized_start=1109
  _DELETEENTRYREQUEST._serialized_end=1228
  _DELETEENTRYRESPONSE._serialized_start=1230
  _DELETEENTRYRESPONSE._serialized_end=1266
  _ATOMICRENAMEENTRYREQUEST._serialized_start=1269
  _ATOMICRENAMEENTRYREQUEST._serialized_end=1397
  _ATOMICRENAMEENTRYRESPONSE._serialized_start=1399
  _ATOMICRENAMEENTRYRESPONSE._serialized_end=1426
  _SUBSCRIBEMETADATAREQUEST._serialized_start=1428
  _SUBSCRIBEMETADATAREQUEST._serialized_end=1534
  _SUBSCRIBEMETADATARESPONSE._serialized_start=1536
  _SUBSCRIBEMETADATARESPONSE._serialized_end=1654
  _EVENTNOTIFICATION._serialized_start=1657
  _EVENTNOTIFICATION._serialized_end=1816
  _GETFILERCONFIGURATIONREQUEST._serialized_start=1818
  _GETFILERCONFIGURATIONREQUEST._serialized_end=1848
  _GETFILERCONFIGURATIONRESPONSE._serialized_start=1850
  _GETFILERCONFIGURATIONRESPONSE._serialized_end=1961
  _SEAWEEDFILER._serialized_start=1964
  _SEAWEEDFILER._serialized_end=2699
# @@protoc_insertion_point(module_scope)
