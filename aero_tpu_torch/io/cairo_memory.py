"""Cairo-memory JSON encoding of proofs (the stark_parser wire format).

Re-implements the reference parser's DynamicMemory model and Writeable
encoders (miden-to-cairo-parser/src/memory.rs:31-123, src/lib.rs:42-436):
values are hex strings ("0x.." uppercase for machine integers, zero-padded
lowercase for field elements), nested arrays live in separate segments
addressed by pointers that are relocated to absolute indices at assembly.
The output feeds the reference Cairo verifier's hints
(src/stark_verifier/utils.py:10 write_into_memory).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from ..spec.field import P
from ..spec.proof import PublicInputs, StarkProof, bytes_to_felts
from ..spec.hashing import hash_elements
from ..spec.merkle import BatchMerkleProof
from ..spec.verifier import VerificationError


class DynamicMemory:
    """Segmented memory with pointer relocation (memory.rs:31-123)."""

    def __init__(self, memories: Optional[list] = None, segment: int = 0):
        if memories is None:
            memories = [[]]
        self.memories = memories
        self.segment = segment

    def _entry(self, e):
        self.memories[self.segment].append(e)

    def write_value(self, v: int):
        self._entry("0x%X" % int(v))

    def write_hex(self, s: str):
        self._entry(s)

    def write_felt(self, v: int):
        self._entry("0x%016x" % int(v))

    def write_pointer_to_new_segment(self) -> "DynamicMemory":
        seg = len(self.memories)
        self._entry(("ptr", seg))
        self.memories.append([])
        return DynamicMemory(self.memories, seg)

    alloc = write_pointer_to_new_segment

    def write_array(self, values, writer) -> None:
        sub = self.alloc()
        for v in values:
            writer(sub, v)

    def write_sized_array(self, values, writer) -> None:
        self.write_value(len(values))
        self.write_array(values, writer)

    def assemble(self) -> List[str]:
        offsets = []
        total = 0
        for seg in self.memories:
            offsets.append(total)
            total += len(seg)
        out = []
        for seg in self.memories:
            for e in seg:
                if isinstance(e, tuple):
                    out.append(str(offsets[e[1]]))
                else:
                    out.append(e)
        return out


def _w_u64(m: DynamicMemory, v: int):
    m.write_value(v)


def _w_felt(m: DynamicMemory, v: int):
    m.write_felt(v)


def _w_digest(m: DynamicMemory, d: bytes):
    """ByteDigest -> 8 x u32 LE words (lib.rs:168-175)."""
    for i in range(8):
        m.write_value(int.from_bytes(d[4 * i:4 * i + 4], "little"))


# ------------------------------------------------------------------ writers

def write_public_inputs(m: DynamicMemory, pub: PublicInputs):
    m.write_sized_array(pub.program_hash, _w_felt)
    m.write_sized_array(pub.stack_inputs, _w_u64)
    m.write_sized_array(pub.output_stack, _w_u64)
    m.write_sized_array(pub.overflow_addrs, _w_u64)


def _write_frame(m: DynamicMemory, current: Sequence[int], nxt: Sequence[int]):
    m.write_sized_array(current, _w_felt)
    m.write_sized_array(nxt, _w_felt)


def _write_table(m: DynamicMemory, rows: List[List[int]]):
    m.write_value(len(rows))
    m.write_value(len(rows[0]) if rows else 0)
    flat = [x for row in rows for x in row]
    m.write_array(flat, _w_felt)


def write_proof(m: DynamicMemory, proof: StarkProof):
    ctx = proof.context
    lay = ctx.layout
    # Context (lib.rs:77-93): TraceLayout, trace_length, log2, meta, modulus,
    # options, lde_domain_size
    m.write_value(lay.main_width)
    m.write_value(lay.num_aux_segments)
    m.write_array(lay.aux_widths, _w_u64)
    m.write_array(lay.aux_rands, _w_u64)
    m.write_value(ctx.trace_length)
    m.write_value(ctx.log_trace_length)
    m.write_value(len(ctx.meta))
    m.write_array(list(ctx.meta), _w_u64)
    m.write_value(len(ctx.field_modulus_bytes))
    m.write_array(list(ctx.field_modulus_bytes), _w_u64)
    opts = ctx.options
    m.write_value(opts.num_queries)
    m.write_value(opts.blowup_factor)
    m.write_value((opts.blowup_factor - 1).bit_length())
    m.write_value(opts.grinding_factor)
    m.write_value(opts.hash_fn)
    m.write_value(opts.field_extension)
    m.write_value(opts.fri_folding_factor)
    m.write_value(opts.fri_max_remainder_size)
    m.write_value(ctx.lde_domain_size)

    # Commitments (lib.rs:95-125)
    sub = m.alloc()
    for d in proof.trace_roots():
        _w_digest(sub, d)
    csub = m.alloc()
    _w_digest(csub, proof.constraint_root())
    fri_roots = proof.fri_roots()
    m.write_value(len(fri_roots))
    fsub = m.alloc()
    for d in fri_roots:
        _w_digest(fsub, d)

    # OodFrame (lib.rs:127-141): main frame, aux frame, evaluations
    mc, mn, ac, an = proof.ood_frame.frames(lay.main_width, lay.aux_width)
    _write_frame(m, mc, mn)
    _write_frame(m, ac, an)
    m.write_sized_array(proof.ood_frame.constraint_evaluations(), _w_felt)

    # pow nonce
    m.write_value(proof.pow_nonce)

    # Trace queries (lib.rs:143-150): main + aux state Tables
    _write_table(m, proof.trace_queries[0].rows(lay.main_width))
    if lay.num_aux_segments:
        _write_table(m, proof.trace_queries[1].rows(lay.aux_width))

    # Constraint queries: evaluations Table
    n_ev = len(proof.ood_frame.constraint_evaluations())
    _write_table(m, proof.constraint_queries.rows(n_ev))

    # FRI remainder inline (lib.rs:73)
    m.write_sized_array(proof.fri_proof.remainder_felts(), _w_felt)


def _digest_words(d: bytes) -> List[int]:
    return [int.from_bytes(d[4 * i:4 * i + 4], "little") for i in range(8)]


def _batch_proof(queries, rows, depth) -> BatchMerkleProof:
    leaves = [hash_elements(r) for r in rows]
    return BatchMerkleProof.deserialize_nodes(queries.paths, leaves, depth)


def write_trace_query_paths(m: DynamicMemory, proof: StarkProof,
                            indexes: List[int]):
    """TraceQueries subcommand (lib.rs:363-378): per segment, one child
    segment holding [len, ptr-to-digests] per query path."""
    lay = proof.context.layout
    depth = proof.context.lde_domain_size.bit_length() - 1
    widths = [lay.main_width] + lay.aux_widths
    for seg, (queries, root) in enumerate(zip(proof.trace_queries,
                                              proof.trace_roots())):
        rows = queries.rows(widths[seg])
        batch = _batch_proof(queries, rows, depth)
        paths = batch.into_paths(indexes)
        child = m.alloc()
        for path in paths:
            child.write_value(len(path))
            sub = child.alloc()
            for d in path:
                _w_digest(sub, d)


def write_constraint_query_paths(m: DynamicMemory, proof: StarkProof,
                                 indexes: List[int]):
    n_ev = len(proof.ood_frame.constraint_evaluations())
    depth = proof.context.lde_domain_size.bit_length() - 1
    rows = proof.constraint_queries.rows(n_ev)
    batch = _batch_proof(proof.constraint_queries, rows, depth)
    paths = batch.into_paths(indexes)
    child = m.alloc()
    for path in paths:
        child.write_value(len(path))
        sub = child.alloc()
        for d in path:
            _w_digest(sub, d)


def write_fri_query_paths(m: DynamicMemory, proof: StarkProof,
                          indexes: List[int]):
    """FriQueries subcommand (lib.rs:395-418): per layer, fold positions,
    then per position [len, ptr-to-path-digests, values...]."""
    ff = proof.context.options.fri_folding_factor
    size = proof.context.lde_domain_size
    idxs = list(indexes)
    for layer in proof.fri_proof.layers:
        target = size // ff
        folded: List[int] = []
        for p in idxs:
            fp = p % target
            if fp not in folded:
                folded.append(fp)
        rows = [bytes_to_felts(layer.values[i * 8 * ff:(i + 1) * 8 * ff])
                for i in range(len(layer.values) // (8 * ff))]
        leaves = [hash_elements(r) for r in rows]
        depth = target.bit_length() - 1
        batch = BatchMerkleProof.deserialize_nodes(layer.paths, leaves, depth)
        paths = batch.into_paths(folded)
        child = m.alloc()
        for i, path in enumerate(paths):
            child.write_value(len(path))
            sub = child.alloc()
            for d in path:
                _w_digest(sub, d)
            vsub = child.alloc()
            for v in rows[i]:
                vsub.write_felt(v)
        idxs = folded
        size = target


# ------------------------------------------------------------------ facade

def to_json(writer, *args) -> str:
    m = DynamicMemory()
    writer(m, *args)
    return json.dumps(m.assemble())
