"""The SDK's protobuf messages read in plain Python.

A reader of the protobuf wire format (varints and length-delimited
fields, the only two kinds `proto/aero.proto` uses) and of the schema's
`StarkProof` and `MidenPublicInputs`, field number by field number. It
turns a serialized `pb.StarkProof` into the reference's `StarkProof` as
the SDK's `_proof_from_pb` lays one out, and checks the wire's enums
(blake2s, no field extension, Goldilocks) on the way, which the native
layout does not carry. It needs no protobuf library and no generated
module.
"""

from __future__ import annotations

from typing import Dict, List

from .field import P
from .proof import (Context, FriProof, FriProofLayer, OodFrame,
                    ProofOptions, PublicInputs, Queries, StarkProof,
                    TraceLayout, felts_to_bytes)


class WireError(ValueError):
    pass


def _varint(buf: bytes, i: int):
    out = shift = 0
    while True:
        if i >= len(buf):
            raise WireError("truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7


def fields(buf: bytes) -> Dict[int, list]:
    """Field number -> its values in order: ints for varints, bytes for
    length-delimited fields."""
    out: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, kind = key >> 3, key & 7
        if kind == 0:
            val, i = _varint(buf, i)
        elif kind == 2:
            n, i = _varint(buf, i)
            if i + n > len(buf):
                raise WireError("truncated field")
            val, i = bytes(buf[i:i + n]), i + n
        else:
            raise WireError(f"wire type {kind} is not in the schema")
        out.setdefault(num, []).append(val)
    return out


def _int(f, num) -> int:
    return f.get(num, [0])[-1]


def _msg(f, num) -> Dict[int, list]:
    return fields(f.get(num, [b""])[-1])


def _msgs(f, num) -> List[Dict[int, list]]:
    return [fields(b) for b in f.get(num, [])]


def _packed(f, num) -> List[int]:
    out: List[int] = []
    for v in f.get(num, []):
        if isinstance(v, int):
            out.append(v)
            continue
        i = 0
        while i < len(v):
            x, i = _varint(v, i)
            out.append(x)
    return out


def _felt(fe: Dict[int, list]) -> int:
    data = fe.get(2, [b""])[-1]
    if len(data) != 8:
        raise WireError("a field element is not 8 bytes")
    return int.from_bytes(data, "little")


def _felts(f, num) -> List[int]:
    return [_felt(m) for m in _msgs(f, num)]


def _digest(d: Dict[int, list]) -> bytes:
    return d.get(2, [b""])[-1]


def _table_bytes(t: Dict[int, list]) -> bytes:
    return felts_to_bytes(_felts(t, 3))


def _nodes_blob(bmp: Dict[int, list]) -> bytes:
    groups = _msgs(bmp, 2)
    out = bytearray([len(groups)])
    for g in groups:
        nodes = [_digest(d) for d in _msgs(g, 1)]
        out.append(len(nodes))
        for d in nodes:
            out += d
    return bytes(out)


def stark_proof(buf: bytes) -> StarkProof:
    """A serialized `pb.StarkProof` as the reference's `StarkProof`."""
    m = fields(buf)
    ctx = _msg(m, 1)
    lay = _msg(ctx, 1)
    opts = _msg(ctx, 5)
    if _int(opts, 4) or _int(opts, 5) or _int(opts, 8):
        raise WireError("the proof's options name another hash, field "
                        "extension or field than blake2s, none, Goldilocks")
    modulus = _felt(_msg(ctx, 4))
    if modulus != P:
        raise WireError(f"field modulus {modulus}")
    layout = TraceLayout(main_width=_int(lay, 1),
                         aux_widths=_packed(lay, 2),
                         aux_rands=_packed(lay, 3))
    if _int(lay, 4) != layout.num_aux_segments:
        raise WireError("num_aux_segments disagrees with the widths")
    context = Context(
        layout=layout, log_trace_length=_int(ctx, 2).bit_length() - 1,
        meta=ctx.get(3, [b""])[-1],
        field_modulus_bytes=modulus.to_bytes(8, "little"),
        options=ProofOptions(
            num_queries=_int(opts, 1), blowup_factor=_int(opts, 2),
            grinding_factor=_int(opts, 3), fri_folding_factor=_int(opts, 6),
            fri_max_remainder_size=_int(opts, 7)))
    com = _msg(m, 2)
    commitments = [_digest(d) for d in _msgs(com, 1)]
    commitments.append(_digest(_msg(com, 2)))
    commitments += [_digest(d) for d in _msgs(com, 3)]
    tq = _msg(m, 3)
    proofs = _msgs(tq, 3)
    trace_queries = [Queries(_table_bytes(_msg(tq, 1)), _nodes_blob(proofs[0]))]
    if layout.num_aux_segments:
        trace_queries.append(Queries(_table_bytes(_msg(tq, 2)),
                                     _nodes_blob(proofs[1])))
    cq = _msg(m, 4)
    constraint_queries = Queries(_table_bytes(_msg(cq, 1)),
                                 _nodes_blob(_msg(cq, 2)))
    ood = _msg(m, 5)
    main_f, aux_f = _msg(ood, 1), _msg(ood, 2)
    cur = _felts(main_f, 1) + _felts(aux_f, 1)
    nxt = _felts(main_f, 2) + _felts(aux_f, 2)
    ood_frame = OodFrame(trace_states=felts_to_bytes(cur + nxt),
                         evaluations=felts_to_bytes(_felts(ood, 3)))
    fri = _msg(m, 6)
    layers = [FriProofLayer(values=felts_to_bytes(_felts(l, 1)),
                            paths=_nodes_blob(_msg(l, 2)))
              for l in _msgs(fri, 1)]
    fri_proof = FriProof(layers=layers,
                         remainder=felts_to_bytes(_felts(fri, 2)),
                         num_partitions=_int(fri, 3))
    return StarkProof(context=context, commitments=commitments,
                      trace_queries=trace_queries,
                      constraint_queries=constraint_queries,
                      ood_frame=ood_frame, fri_proof=fri_proof,
                      pow_nonce=_int(m, 7))


def public_inputs(buf: bytes) -> PublicInputs:
    """A serialized `pb.MidenPublicInputs` as the reference's
    `PublicInputs`."""
    m = fields(buf)
    digest = _digest(_msg(m, 1))
    if len(digest) != 32:
        raise WireError("the program hash is not 32 bytes")
    outs = _msg(m, 3)
    return PublicInputs(
        program_hash=[int.from_bytes(digest[k:k + 8], "little")
                      for k in range(0, 32, 8)],
        stack_inputs=_felts(m, 2), output_stack=_felts(outs, 1),
        overflow_addrs=_felts(outs, 2))
