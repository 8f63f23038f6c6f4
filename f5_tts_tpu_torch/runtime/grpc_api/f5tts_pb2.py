# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: f5tts.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x66\x35tts.proto\x12\x05\x66\x35tts\"\x86\x01\n\x11SynthesizeRequest\x12\x13\n\x0btarget_text\x18\x01 \x01(\t\x12\x16\n\x0ereference_text\x18\x02 \x01(\t\x12\x15\n\rreference_wav\x18\x03 \x01(\x0c\x12\x0c\n\x04seed\x18\x04 \x01(\x03\x12\x10\n\x08has_seed\x18\x05 \x01(\x08\x12\r\n\x05speed\x18\x06 \x01(\x02\"O\n\x12SynthesizeResponse\x12\x10\n\x08waveform\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\x12\n\nduration_s\x18\x03 \x01(\x02\"\x0e\n\x0cStatsRequest\"\x1d\n\rStatsResponse\x12\x0c\n\x04json\x18\x01 \x01(\t\"\x0f\n\rHealthRequest\" \n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t2\x83\x02\n\x05\x46\x35TTS\x12\x41\n\nSynthesize\x12\x18.f5tts.SynthesizeRequest\x1a\x19.f5tts.SynthesizeResponse\x12I\n\x10SynthesizeStream\x12\x18.f5tts.SynthesizeRequest\x1a\x19.f5tts.SynthesizeResponse0\x01\x12\x35\n\x08GetStats\x12\x13.f5tts.StatsRequest\x1a\x14.f5tts.StatsResponse\x12\x35\n\x06Health\x12\x14.f5tts.HealthRequest\x1a\x15.f5tts.HealthResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'f5tts_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SYNTHESIZEREQUEST._serialized_start=23
  _SYNTHESIZEREQUEST._serialized_end=157
  _SYNTHESIZERESPONSE._serialized_start=159
  _SYNTHESIZERESPONSE._serialized_end=238
  _STATSREQUEST._serialized_start=240
  _STATSREQUEST._serialized_end=254
  _STATSRESPONSE._serialized_start=256
  _STATSRESPONSE._serialized_end=285
  _HEALTHREQUEST._serialized_start=287
  _HEALTHREQUEST._serialized_end=302
  _HEALTHRESPONSE._serialized_start=304
  _HEALTHRESPONSE._serialized_end=336
  _F5TTS._serialized_start=339
  _F5TTS._serialized_end=598
# @@protoc_insertion_point(module_scope)
