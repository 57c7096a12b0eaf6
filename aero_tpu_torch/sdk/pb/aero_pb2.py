# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: aero.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\naero.proto\x12\x03sdk\"\x1f\n\x0c\x46ieldElement\x12\x0f\n\x07\x65lement\x18\x02 \x01(\x0c\"L\n\x05Table\x12\x0e\n\x06n_rows\x18\x01 \x01(\r\x12\x0e\n\x06n_cols\x18\x02 \x01(\r\x12#\n\x08\x65lements\x18\x03 \x03(\x0b\x32\x11.sdk.FieldElement\"\x16\n\x06\x44igest\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\"\x87\x02\n\x0cProofOptions\x12\x13\n\x0bnum_queries\x18\x01 \x01(\r\x12\x15\n\rblowup_factor\x18\x02 \x01(\r\x12\x17\n\x0fgrinding_factor\x18\x03 \x01(\r\x12\"\n\x07hash_fn\x18\x04 \x01(\x0e\x32\x11.sdk.HashFunction\x12,\n\x0f\x66ield_extension\x18\x05 \x01(\x0e\x32\x13.sdk.FieldExtension\x12\x1a\n\x12\x66ri_folding_factor\x18\x06 \x01(\r\x12\x1e\n\x16\x66ri_max_remainder_size\x18\x07 \x01(\r\x12$\n\x0bprime_field\x18\x08 \x01(\x0e\x32\x0f.sdk.PrimeField\"\x82\x01\n\x0bTraceLayout\x12\x1a\n\x12main_segment_width\x18\x01 \x01(\x04\x12\x1e\n\x12\x61ux_segment_widths\x18\x02 \x03(\x04\x42\x02\x10\x01\x12\x1d\n\x11\x61ux_segment_rands\x18\x03 \x03(\x04\x42\x02\x10\x01\x12\x18\n\x10num_aux_segments\x18\x04 \x01(\x04\"\xa9\x01\n\x07\x43ontext\x12&\n\x0ctrace_layout\x18\x01 \x01(\x0b\x32\x10.sdk.TraceLayout\x12\x14\n\x0ctrace_length\x18\x02 \x01(\x04\x12\x12\n\ntrace_meta\x18\x03 \x01(\x0c\x12(\n\rfield_modulus\x18\x04 \x01(\x0b\x32\x11.sdk.FieldElement\x12\"\n\x07options\x18\x05 \x01(\x0b\x32\x11.sdk.ProofOptions\"u\n\x0b\x43ommitments\x12 \n\x0btrace_roots\x18\x01 \x03(\x0b\x32\x0b.sdk.Digest\x12$\n\x0f\x63onstraint_root\x18\x02 \x01(\x0b\x32\x0b.sdk.Digest\x12\x1e\n\tfri_roots\x18\x03 \x03(\x0b\x32\x0b.sdk.Digest\"3\n\x15\x42\x61tchMerkleProofLayer\x12\x1a\n\x05nodes\x18\x01 \x03(\x0b\x32\x0b.sdk.Digest\"i\n\x10\x42\x61tchMerkleProof\x12\x1b\n\x06leaves\x18\x01 \x03(\x0b\x32\x0b.sdk.Digest\x12)\n\x05nodes\x18\x02 \x03(\x0b\x32\x1a.sdk.BatchMerkleProofLayer\x12\r\n\x05\x64\x65pth\x18\x03 \x01(\r\"|\n\x0cTraceQueries\x12\x1f\n\x0bmain_states\x18\x01 \x01(\x0b\x32\n.sdk.Table\x12\x1e\n\naux_states\x18\x02 \x01(\x0b\x32\n.sdk.Table\x12+\n\x0cquery_proofs\x18\x03 \x03(\x0b\x32\x15.sdk.BatchMerkleProof\"`\n\x11\x43onstraintQueries\x12\x1f\n\x0b\x65valuations\x18\x01 \x01(\x0b\x32\n.sdk.Table\x12*\n\x0bquery_proof\x18\x02 \x01(\x0b\x32\x15.sdk.BatchMerkleProof\"V\n\x0f\x45valuationFrame\x12\"\n\x07\x63urrent\x18\x01 \x03(\x0b\x32\x11.sdk.FieldElement\x12\x1f\n\x04next\x18\x02 \x03(\x0b\x32\x11.sdk.FieldElement\"\x85\x01\n\x08OodFrame\x12(\n\nmain_frame\x18\x01 \x01(\x0b\x32\x14.sdk.EvaluationFrame\x12\'\n\taux_frame\x18\x02 \x01(\x0b\x32\x14.sdk.EvaluationFrame\x12&\n\x0b\x65valuations\x18\x03 \x03(\x0b\x32\x11.sdk.FieldElement\"Y\n\rFriProofLayer\x12!\n\x06values\x18\x01 \x03(\x0b\x32\x11.sdk.FieldElement\x12%\n\x06proofs\x18\x02 \x01(\x0b\x32\x15.sdk.BatchMerkleProof\"l\n\x08\x46riProof\x12\"\n\x06layers\x18\x01 \x03(\x0b\x32\x12.sdk.FriProofLayer\x12$\n\tremainder\x18\x02 \x03(\x0b\x32\x11.sdk.FieldElement\x12\x16\n\x0enum_partitions\x18\x03 \x01(\r\"\x87\x02\n\nStarkProof\x12\x1d\n\x07\x63ontext\x18\x01 \x01(\x0b\x32\x0c.sdk.Context\x12%\n\x0b\x63ommitments\x18\x02 \x01(\x0b\x32\x10.sdk.Commitments\x12(\n\rtrace_queries\x18\x03 \x01(\x0b\x32\x11.sdk.TraceQueries\x12\x32\n\x12\x63onstraint_queries\x18\x04 \x01(\x0b\x32\x16.sdk.ConstraintQueries\x12 \n\tood_frame\x18\x05 \x01(\x0b\x32\r.sdk.OodFrame\x12 \n\tfri_proof\x18\x06 \x01(\x0b\x32\r.sdk.FriProof\x12\x11\n\tpow_nonce\x18\x07 \x01(\x04\"\x1f\n\x0cMidenProgram\x12\x0f\n\x07program\x18\x01 \x01(\t\"=\n\x12MidenProgramInputs\x12\x12\n\nstack_init\x18\x01 \x03(\x04\x12\x13\n\x0b\x61\x64vice_tape\x18\x02 \x03(\x04\"b\n\x13MidenProgramOutputs\x12 \n\x05stack\x18\x01 \x03(\x0b\x32\x11.sdk.FieldElement\x12)\n\x0eoverflow_addrs\x18\x02 \x03(\x0b\x32\x11.sdk.FieldElement\"\x8a\x01\n\x11MidenPublicInputs\x12!\n\x0cprogram_hash\x18\x01 \x01(\x0b\x32\x0b.sdk.Digest\x12\'\n\x0cstack_inputs\x18\x02 \x03(\x0b\x32\x11.sdk.FieldElement\x12)\n\x07outputs\x18\x03 \x01(\x0b\x32\x18.sdk.MidenProgramOutputs\"\xc4\x01\n\x16ProofSubmissionRequest\x12\x1e\n\x05proof\x18\x01 \x01(\x0b\x32\x0f.sdk.StarkProof\x12-\n\rpublic_inputs\x18\x02 \x01(\x0b\x32\x16.sdk.MidenPublicInputs\x12\x33\n\x13source_proof_system\x18\x03 \x01(\x0e\x32\x16.sdk.SourceProofSystem\x12&\n\x0ctarget_chain\x18\x04 \x01(\x0e\x32\x10.sdk.TargetChain\"*\n\x17ProofSubmissionResponse\x12\x0f\n\x07receipt\x18\x01 \x01(\t*\x1b\n\x0cHashFunction\x12\x0b\n\x07\x42LAKE2S\x10\x00*\x1a\n\x0e\x46ieldExtension\x12\x08\n\x04NONE\x10\x00*\x1c\n\nPrimeField\x12\x0e\n\nGOLDILOCKS\x10\x00*\x1b\n\x0bTargetChain\x12\x0c\n\x08STARKNET\x10\x00*\x1e\n\x11SourceProofSystem\x12\t\n\x05MIDEN\x10\x00\x32\x62\n\x16ProofSubmissionService\x12H\n\x0bSubmitProof\x12\x1b.sdk.ProofSubmissionRequest\x1a\x1c.sdk.ProofSubmissionResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'aero_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRACELAYOUT.fields_by_name['aux_segment_widths']._options = None
  _TRACELAYOUT.fields_by_name['aux_segment_widths']._serialized_options = b'\020\001'
  _TRACELAYOUT.fields_by_name['aux_segment_rands']._options = None
  _TRACELAYOUT.fields_by_name['aux_segment_rands']._serialized_options = b'\020\001'
  _HASHFUNCTION._serialized_start=2499
  _HASHFUNCTION._serialized_end=2526
  _FIELDEXTENSION._serialized_start=2528
  _FIELDEXTENSION._serialized_end=2554
  _PRIMEFIELD._serialized_start=2556
  _PRIMEFIELD._serialized_end=2584
  _TARGETCHAIN._serialized_start=2586
  _TARGETCHAIN._serialized_end=2613
  _SOURCEPROOFSYSTEM._serialized_start=2615
  _SOURCEPROOFSYSTEM._serialized_end=2645
  _FIELDELEMENT._serialized_start=19
  _FIELDELEMENT._serialized_end=50
  _TABLE._serialized_start=52
  _TABLE._serialized_end=128
  _DIGEST._serialized_start=130
  _DIGEST._serialized_end=152
  _PROOFOPTIONS._serialized_start=155
  _PROOFOPTIONS._serialized_end=418
  _TRACELAYOUT._serialized_start=421
  _TRACELAYOUT._serialized_end=551
  _CONTEXT._serialized_start=554
  _CONTEXT._serialized_end=723
  _COMMITMENTS._serialized_start=725
  _COMMITMENTS._serialized_end=842
  _BATCHMERKLEPROOFLAYER._serialized_start=844
  _BATCHMERKLEPROOFLAYER._serialized_end=895
  _BATCHMERKLEPROOF._serialized_start=897
  _BATCHMERKLEPROOF._serialized_end=1002
  _TRACEQUERIES._serialized_start=1004
  _TRACEQUERIES._serialized_end=1128
  _CONSTRAINTQUERIES._serialized_start=1130
  _CONSTRAINTQUERIES._serialized_end=1226
  _EVALUATIONFRAME._serialized_start=1228
  _EVALUATIONFRAME._serialized_end=1314
  _OODFRAME._serialized_start=1317
  _OODFRAME._serialized_end=1450
  _FRIPROOFLAYER._serialized_start=1452
  _FRIPROOFLAYER._serialized_end=1541
  _FRIPROOF._serialized_start=1543
  _FRIPROOF._serialized_end=1651
  _STARKPROOF._serialized_start=1654
  _STARKPROOF._serialized_end=1917
  _MIDENPROGRAM._serialized_start=1919
  _MIDENPROGRAM._serialized_end=1950
  _MIDENPROGRAMINPUTS._serialized_start=1952
  _MIDENPROGRAMINPUTS._serialized_end=2013
  _MIDENPROGRAMOUTPUTS._serialized_start=2015
  _MIDENPROGRAMOUTPUTS._serialized_end=2113
  _MIDENPUBLICINPUTS._serialized_start=2116
  _MIDENPUBLICINPUTS._serialized_end=2254
  _PROOFSUBMISSIONREQUEST._serialized_start=2257
  _PROOFSUBMISSIONREQUEST._serialized_end=2453
  _PROOFSUBMISSIONRESPONSE._serialized_start=2455
  _PROOFSUBMISSIONRESPONSE._serialized_end=2497
  _PROOFSUBMISSIONSERVICE._serialized_start=2647
  _PROOFSUBMISSIONSERVICE._serialized_end=2745
# @@protoc_insertion_point(module_scope)
