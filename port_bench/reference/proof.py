"""STARK proof container + winterfell-0.4-compatible binary serialization.

Byte layout reverse-engineered from the golden artifact (reference:
proofs/fib.bin, produced by miden-proof-generator/src/main.rs:49-51) and the
reference parser (miden-to-cairo-parser/src/lib.rs):

file := bincode ProofData { input_bytes: Vec<u8>, proof_bytes: Vec<u8> }
        (u64-LE length prefix per vec)

proof_bytes :=
  Context:
    u8 main_trace_width, u8 aux_segment_width, u8 aux_segment_rands
    u8 log2(trace_length)
    u16 trace_meta_len, meta bytes
    u8 field_modulus_len, modulus bytes (LE)
  ProofOptions:
    u8 num_queries, u8 blowup_factor, u8 grinding_factor,
    u8 hash_fn (4 = blake2s_256), u8 field_extension (1 = none),
    u8 fri_folding_factor, u8 log2(fri_max_remainder_size)
  Commitments: u16 total_bytes, then digests (trace segments ++ constraint ++
    fri layer roots ++ fri remainder root), 32 bytes each
  Trace queries, one per segment:  u32 values_len + values (row-major felts,
    8B LE, rows in query draw order) + u32 paths_len + batch proof nodes blob
  Constraint queries: same shape
  OodFrame: u16 len + trace states (main.current ++ main.next ++ aux.current
    ++ aux.next) + u16 len + evaluations
  FriProof: u8 num_layers; per layer: u32 values_len + values + u32 paths_len
    + nodes blob; u16 remainder_len + remainder felts; u8 num_partitions
  u64 pow_nonce

Frozen copy of the port's `spec/proof.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List

HASH_BLAKE2S = 4
EXTENSION_NONE = 1


@dataclass
class ProofOptions:
    num_queries: int = 27
    blowup_factor: int = 8
    grinding_factor: int = 16
    hash_fn: int = HASH_BLAKE2S
    field_extension: int = EXTENSION_NONE
    fri_folding_factor: int = 8
    fri_max_remainder_size: int = 256  # stored as log2

    def to_bytes(self) -> bytes:
        return bytes([
            self.num_queries, self.blowup_factor, self.grinding_factor,
            self.hash_fn, self.field_extension, self.fri_folding_factor,
            (self.fri_max_remainder_size - 1).bit_length(),
        ])

    @classmethod
    def parse(cls, r: "Reader") -> "ProofOptions":
        return cls(
            num_queries=r.u8(), blowup_factor=r.u8(), grinding_factor=r.u8(),
            hash_fn=r.u8(), field_extension=r.u8(), fri_folding_factor=r.u8(),
            fri_max_remainder_size=1 << r.u8(),
        )


@dataclass
class TraceLayout:
    main_width: int = 72
    aux_widths: List[int] = field(default_factory=lambda: [9])
    aux_rands: List[int] = field(default_factory=lambda: [16])

    @property
    def num_aux_segments(self) -> int:
        return len(self.aux_widths)

    @property
    def aux_width(self) -> int:
        return sum(self.aux_widths)

    @property
    def full_width(self) -> int:
        return self.main_width + self.aux_width


@dataclass
class Context:
    layout: TraceLayout
    log_trace_length: int
    meta: bytes
    field_modulus_bytes: bytes
    options: ProofOptions

    @property
    def trace_length(self) -> int:
        return 1 << self.log_trace_length

    @property
    def lde_domain_size(self) -> int:
        return self.trace_length * self.options.blowup_factor

    def to_bytes(self) -> bytes:
        assert len(self.layout.aux_widths) == 1, "single aux segment supported"
        out = bytes([self.layout.main_width, self.layout.aux_widths[0],
                     self.layout.aux_rands[0], self.log_trace_length])
        out += struct.pack("<H", len(self.meta)) + self.meta
        out += bytes([len(self.field_modulus_bytes)]) + self.field_modulus_bytes
        out += self.options.to_bytes()
        return out

    @classmethod
    def parse(cls, r: "Reader") -> "Context":
        layout = TraceLayout(main_width=r.u8(), aux_widths=[r.u8()],
                             aux_rands=[r.u8()])
        log_trace_length = r.u8()
        meta = r.take(r.u16())
        modulus = r.take(r.u8())
        options = ProofOptions.parse(r)
        return cls(layout, log_trace_length, meta, modulus, options)


@dataclass
class Queries:
    """Opened values + compressed batch-proof nodes for one commitment."""
    values: bytes      # row-major felts, 8-byte LE, rows in query order
    paths: bytes       # serialized batch proof nodes blob

    def to_bytes(self) -> bytes:
        return (struct.pack("<I", len(self.values)) + self.values
                + struct.pack("<I", len(self.paths)) + self.paths)

    @classmethod
    def parse(cls, r: "Reader") -> "Queries":
        values = r.take(r.u32())
        paths = r.take(r.u32())
        return cls(values, paths)

    def rows(self, n_cols: int) -> List[List[int]]:
        felts = bytes_to_felts(self.values)
        assert len(felts) % n_cols == 0
        return [felts[i:i + n_cols] for i in range(0, len(felts), n_cols)]


@dataclass
class OodFrame:
    trace_states: bytes   # main.current ++ main.next ++ aux.current ++ aux.next
    evaluations: bytes    # constraint composition column evals at z^m

    def to_bytes(self) -> bytes:
        return (struct.pack("<H", len(self.trace_states)) + self.trace_states
                + struct.pack("<H", len(self.evaluations)) + self.evaluations)

    @classmethod
    def parse(cls, r: "Reader") -> "OodFrame":
        ts = r.take(r.u16())
        ev = r.take(r.u16())
        return cls(ts, ev)

    def frames(self, main_width: int, aux_width: int):
        """Returns (main_current, main_next, aux_current, aux_next).

        trace_states is row-major: full current row (main ++ aux), then full
        next row — validated against the golden proof's Fiat-Shamir chain.
        """
        felts = bytes_to_felts(self.trace_states)
        w = main_width + aux_width
        assert len(felts) == 2 * w
        cur, nxt = felts[:w], felts[w:]
        return (cur[:main_width], nxt[:main_width],
                cur[main_width:], nxt[main_width:])

    def constraint_evaluations(self) -> List[int]:
        return bytes_to_felts(self.evaluations)


@dataclass
class FriProofLayer:
    values: bytes   # leaf rows (folding_factor felts each), in folded order
    paths: bytes    # batch proof nodes blob

    to_bytes = Queries.to_bytes
    parse = classmethod(Queries.parse.__func__)


@dataclass
class FriProof:
    layers: List[FriProofLayer]
    remainder: bytes       # felts, 8-byte LE
    num_partitions: int    # stored as log2 in winterfell? golden value: 0

    def to_bytes(self) -> bytes:
        out = bytes([len(self.layers)])
        out += b"".join(l.to_bytes() for l in self.layers)
        out += struct.pack("<H", len(self.remainder)) + self.remainder
        out += bytes([self.num_partitions])
        return out

    @classmethod
    def parse(cls, r: "Reader") -> "FriProof":
        num_layers = r.u8()
        layers = [FriProofLayer.parse(r) for _ in range(num_layers)]
        remainder = r.take(r.u16())
        num_partitions = r.u8()
        return cls(layers, remainder, num_partitions)

    def remainder_felts(self) -> List[int]:
        return bytes_to_felts(self.remainder)


@dataclass
class StarkProof:
    context: Context
    commitments: List[bytes]         # trace roots ++ constraint root ++ fri roots
    trace_queries: List[Queries]     # one per trace segment
    constraint_queries: Queries
    ood_frame: OodFrame
    fri_proof: FriProof
    pow_nonce: int

    # --- derived ---
    @property
    def options(self) -> ProofOptions:
        return self.context.options

    def num_fri_layers(self) -> int:
        n = self.context.lde_domain_size
        cnt = 0
        while n > self.options.fri_max_remainder_size:
            cnt += 1
            n //= self.options.fri_folding_factor
        return cnt

    def trace_roots(self) -> List[bytes]:
        return self.commitments[:1 + self.context.layout.num_aux_segments]

    def constraint_root(self) -> bytes:
        return self.commitments[1 + self.context.layout.num_aux_segments]

    def fri_roots(self) -> List[bytes]:
        return self.commitments[2 + self.context.layout.num_aux_segments:]

    def to_bytes(self) -> bytes:
        commitment_bytes = b"".join(self.commitments)
        out = self.context.to_bytes()
        out += struct.pack("<H", len(commitment_bytes)) + commitment_bytes
        out += b"".join(q.to_bytes() for q in self.trace_queries)
        out += self.constraint_queries.to_bytes()
        out += self.ood_frame.to_bytes()
        out += self.fri_proof.to_bytes()
        out += struct.pack("<Q", self.pow_nonce)
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "StarkProof":
        r = Reader(data)
        context = Context.parse(r)
        commitment_bytes = r.take(r.u16())
        assert len(commitment_bytes) % 32 == 0
        commitments = [commitment_bytes[i:i + 32]
                       for i in range(0, len(commitment_bytes), 32)]
        num_segments = 1 + context.layout.num_aux_segments
        trace_queries = [Queries.parse(r) for _ in range(num_segments)]
        constraint_queries = Queries.parse(r)
        ood_frame = OodFrame.parse(r)
        fri_proof = FriProof.parse(r)
        pow_nonce = r.u64()
        if not r.done():
            raise ValueError(f"trailing proof bytes: {r.remaining()}")
        return cls(context, commitments, trace_queries, constraint_queries,
                   ood_frame, fri_proof, pow_nonce)


@dataclass
class PublicInputs:
    """Miden VM public inputs (program hash, input stack, outputs)."""
    program_hash: List[int]          # 4 felts
    stack_inputs: List[int]
    output_stack: List[int]
    overflow_addrs: List[int]

    def elements(self) -> List[int]:
        """Flat element list in Fiat-Shamir seeding order (random.cairo:254)."""
        return (list(self.program_hash) + list(self.stack_inputs)
                + list(self.output_stack) + list(self.overflow_addrs))

    def to_bytes(self) -> bytes:
        out = b"".join(int(x).to_bytes(8, "little") for x in self.program_hash)
        for vec in (self.stack_inputs, self.output_stack, self.overflow_addrs):
            out += struct.pack("<Q", len(vec))
            out += b"".join(int(x).to_bytes(8, "little") for x in vec)
        return out

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicInputs":
        r = Reader(data)
        program_hash = [r.u64() for _ in range(4)]
        vecs = []
        for _ in range(3):
            n = r.u64()
            vecs.append([r.u64() for _ in range(n)])
        if not r.done():
            raise ValueError("trailing public input bytes")
        return cls(program_hash, *vecs)


def bytes_to_felts(data: bytes) -> List[int]:
    assert len(data) % 8 == 0
    return [int.from_bytes(data[i:i + 8], "little") for i in range(0, len(data), 8)]


def felts_to_bytes(felts) -> bytes:
    return b"".join(int(x).to_bytes(8, "little") for x in felts)


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("unexpected end of data")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def done(self) -> bool:
        return self.off == len(self.data)

    def remaining(self) -> int:
        return len(self.data) - self.off
