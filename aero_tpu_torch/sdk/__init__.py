"""SDK facade and protobuf wire layer: execute and prove a program.

The counterpart of `aero_tpu/sdk/__init__.py`, proving through this package.
Callers submit a program, inputs and options as protobuf messages and get
the outputs, public inputs and STARK proof back as protobuf: the same wire
schema (`proto/aero.proto`) and the same defaults (27 queries, blowup 8,
16-bit grinding, blake2s, FRI folding 8, remainder 256, Goldilocks), so the
same request gives the same `pb.StarkProof` bytes from either package.

`prove` runs on the CUDA card unless the caller names another device; it
never falls back to the CPU. `ProofSubmissionService` verifies a submitted
proof with this package's `spec.verifier` and returns a receipt binding
proof and public inputs (`sdk/server.py` serves it over HTTP).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

from .pb import aero_pb2 as pb
from .._device import resolve_device
from ..spec.proof import (ProofOptions, PublicInputs, StarkProof,
                          bytes_to_felts, felts_to_bytes)
from ..utils import span

DEFAULT_OPTIONS = ProofOptions(num_queries=27, blowup_factor=8,
                               grinding_factor=16, fri_folding_factor=8,
                               fri_max_remainder_size=256)


def _felt(v: int) -> pb.FieldElement:
    return pb.FieldElement(element=int(v).to_bytes(8, "little"))


def _felt_val(fe: pb.FieldElement) -> int:
    return int.from_bytes(fe.element, "little")


def options_to_pb(o: ProofOptions) -> pb.ProofOptions:
    return pb.ProofOptions(
        num_queries=o.num_queries, blowup_factor=o.blowup_factor,
        grinding_factor=o.grinding_factor, hash_fn=pb.BLAKE2S,
        field_extension=pb.NONE, fri_folding_factor=o.fri_folding_factor,
        fri_max_remainder_size=o.fri_max_remainder_size,
        prime_field=pb.GOLDILOCKS)


def options_from_pb(o: pb.ProofOptions) -> ProofOptions:
    return ProofOptions(
        num_queries=o.num_queries, blowup_factor=o.blowup_factor,
        grinding_factor=o.grinding_factor,
        fri_folding_factor=o.fri_folding_factor,
        fri_max_remainder_size=o.fri_max_remainder_size)


def proof_to_pb(proof: StarkProof) -> pb.StarkProof:
    """Convert the native proof into the SDK wire format (the reference's
    IntoSdk converters, miden-wasm/src/convert/convert_proof.rs)."""
    ctx = proof.context
    lay = ctx.layout
    out = pb.StarkProof()
    out.context.trace_layout.main_segment_width = lay.main_width
    out.context.trace_layout.aux_segment_widths.extend(lay.aux_widths)
    out.context.trace_layout.aux_segment_rands.extend(lay.aux_rands)
    out.context.trace_layout.num_aux_segments = lay.num_aux_segments
    out.context.trace_length = ctx.trace_length
    out.context.trace_meta = ctx.meta
    out.context.field_modulus.element = ctx.field_modulus_bytes
    out.context.options.CopyFrom(options_to_pb(ctx.options))

    for d in proof.trace_roots():
        out.commitments.trace_roots.add(data=d)
    out.commitments.constraint_root.data = proof.constraint_root()
    for d in proof.fri_roots():
        out.commitments.fri_roots.add(data=d)

    def fill_table(table, rows):
        table.n_rows = len(rows)
        table.n_cols = len(rows[0]) if rows else 0
        for row in rows:
            for v in row:
                table.elements.add(element=int(v).to_bytes(8, "little"))

    def fill_batch_proof(dst, paths_blob: bytes, depth: int):
        dst.depth = depth
        n_groups = paths_blob[0]
        off = 1
        for _ in range(n_groups):
            cnt = paths_blob[off]
            off += 1
            grp = dst.nodes.add()
            for _ in range(cnt):
                grp.nodes.add(data=paths_blob[off:off + 32])
                off += 32

    depth = ctx.lde_domain_size.bit_length() - 1
    fill_table(out.trace_queries.main_states,
               proof.trace_queries[0].rows(lay.main_width))
    fill_batch_proof(out.trace_queries.query_proofs.add(),
                     proof.trace_queries[0].paths, depth)
    if lay.num_aux_segments:
        fill_table(out.trace_queries.aux_states,
                   proof.trace_queries[1].rows(lay.aux_width))
        fill_batch_proof(out.trace_queries.query_proofs.add(),
                         proof.trace_queries[1].paths, depth)
    n_ev = len(proof.ood_frame.constraint_evaluations())
    fill_table(out.constraint_queries.evaluations,
               proof.constraint_queries.rows(n_ev))
    fill_batch_proof(out.constraint_queries.query_proof,
                     proof.constraint_queries.paths, depth)

    mc, mn, ac, an = proof.ood_frame.frames(lay.main_width, lay.aux_width)
    for v in mc:
        out.ood_frame.main_frame.current.append(_felt(v))
    for v in mn:
        out.ood_frame.main_frame.next.append(_felt(v))
    for v in ac:
        out.ood_frame.aux_frame.current.append(_felt(v))
    for v in an:
        out.ood_frame.aux_frame.next.append(_felt(v))
    for v in proof.ood_frame.constraint_evaluations():
        out.ood_frame.evaluations.append(_felt(v))

    ff = ctx.options.fri_folding_factor
    for layer in proof.fri_proof.layers:
        l = out.fri_proof.layers.add()
        for v in bytes_to_felts(layer.values):
            l.values.append(_felt(v))
        # nodes blob -> BatchMerkleProof message (leaves omitted: they are
        # recomputed from values by verifiers, as in the reference)
        blob = layer.paths
        n_groups = blob[0]
        off = 1
        for _ in range(n_groups):
            cnt = blob[off]
            off += 1
            lay_pb = l.proofs.nodes.add()
            for _ in range(cnt):
                lay_pb.nodes.add(data=blob[off:off + 32])
                off += 32
    for v in proof.fri_proof.remainder_felts():
        out.fri_proof.remainder.append(_felt(v))
    out.fri_proof.num_partitions = proof.fri_proof.num_partitions
    out.pow_nonce = proof.pow_nonce
    return out


def public_inputs_to_pb(pub: PublicInputs) -> pb.MidenPublicInputs:
    out = pb.MidenPublicInputs()
    out.program_hash.data = felts_to_bytes(pub.program_hash)
    for v in pub.stack_inputs:
        out.stack_inputs.append(_felt(v))
    for v in pub.output_stack:
        out.outputs.stack.append(_felt(v))
    for v in pub.overflow_addrs:
        out.outputs.overflow_addrs.append(_felt(v))
    return out


@dataclass
class ProveResult:
    outputs: pb.MidenProgramOutputs
    public_inputs: pb.MidenPublicInputs
    proof: pb.StarkProof
    native_proof: StarkProof
    native_pub: PublicInputs


def prove(program: pb.MidenProgram, inputs: pb.MidenProgramInputs,
          options: Optional[pb.ProofOptions] = None, min_rows: int = 64,
          device=None) -> ProveResult:
    """Execute `program` on the VM and prove the trace on `device` (the
    CUDA card when `device` is None). The span `execute` holds three that
    partition it: `vm_execute` (the VM run), `air_build` (the program
    hash, the public inputs and the AIR) and `trace_upload` (the trace's
    copy to the device, which waits for the stream on a card)."""
    from ..air.miden import MidenAir, make_public_inputs
    from ..field import from_u64
    from ..prover import prove as run_prover
    from ..vm import execute_full, program_hash

    device = resolve_device(device)
    opts = options_from_pb(options) if options is not None \
        else DEFAULT_OPTIONS
    stack_init = list(inputs.stack_init)
    with span("execute"):
        with span("vm_execute"):
            trace, out_stack, overflow = execute_full(
                program.program, list(reversed(stack_init)),
                advice_tape=list(inputs.advice_tape), min_rows=min_rows)
        with span("air_build"):
            pub = make_public_inputs(program_hash(program.program),
                                     list(reversed(stack_init)), out_stack,
                                     overflow=overflow)
            air = MidenAir(trace.shape[1], pub, opts,
                           program=program.program)
        with span("trace_upload"):
            main_trace = from_u64(trace, device)
    proof = run_prover(air, main_trace, pub)
    with span("to_pb"):
        pub_pb = public_inputs_to_pb(pub)
        proof_pb = proof_to_pb(proof)
    return ProveResult(outputs=pub_pb.outputs, public_inputs=pub_pb,
                       proof=proof_pb, native_proof=proof, native_pub=pub)


def prove_sequential(program: pb.MidenProgram, inputs: pb.MidenProgramInputs,
                     options: Optional[pb.ProofOptions] = None,
                     min_rows: int = 64, device=None) -> ProveResult:
    """An alias of `prove`, as `aero_tpu.sdk.prove_sequential` is: the
    pipeline has one path, and the name is kept so that callers of the
    reference SDK's two entry points (`tools/demo.py`) run unchanged."""
    return prove(program, inputs, options, min_rows=min_rows, device=device)


class ProofSubmissionService:
    """In-process implementation of the declared-but-unimplemented
    reference service (service.proto): verifies the submitted proof and
    returns a receipt binding proof + public inputs."""

    def submit_proof(self, request: pb.ProofSubmissionRequest
                     ) -> pb.ProofSubmissionResponse:
        from ..spec.verifier import verify, VerificationError
        proof_bytes = request.proof.SerializeToString()
        # convert wire proof back to native for verification
        native = _proof_from_pb(request.proof)
        pub = _public_inputs_from_pb(request.public_inputs)
        verify(native, pub)  # raises on invalid proofs
        receipt = hashlib.blake2s(
            proof_bytes + request.public_inputs.SerializeToString()).hexdigest()
        return pb.ProofSubmissionResponse(receipt=receipt)


def _public_inputs_from_pb(m: pb.MidenPublicInputs) -> PublicInputs:
    return PublicInputs(
        program_hash=bytes_to_felts(m.program_hash.data),
        stack_inputs=[_felt_val(x) for x in m.stack_inputs],
        output_stack=[_felt_val(x) for x in m.outputs.stack],
        overflow_addrs=[_felt_val(x) for x in m.outputs.overflow_addrs])


def _proof_from_pb(m: pb.StarkProof) -> StarkProof:
    from ..spec.proof import (Context, TraceLayout, Queries, OodFrame,
                              FriProof, FriProofLayer)
    lay = TraceLayout(main_width=int(m.context.trace_layout.main_segment_width),
                      aux_widths=[int(x) for x in m.context.trace_layout.aux_segment_widths],
                      aux_rands=[int(x) for x in m.context.trace_layout.aux_segment_rands])
    ctx = Context(layout=lay,
                  log_trace_length=int(m.context.trace_length).bit_length() - 1,
                  meta=bytes(m.context.trace_meta),
                  field_modulus_bytes=bytes(m.context.field_modulus.element),
                  options=options_from_pb(m.context.options))

    def table_queries(table, paths_blob):
        vals = b"".join(x.element for x in table.elements)
        return Queries(values=vals, paths=paths_blob)

    def nodes_blob(bmp) -> bytes:
        out = bytearray([len(bmp.nodes)])
        for grp in bmp.nodes:
            out.append(len(grp.nodes))
            for d in grp.nodes:
                out += d.data
        return bytes(out)

    # wire format does not carry the compressed trace/constraint node blobs
    # separately per segment in this SDK path; reconstruct via query_proofs
    tq = [table_queries(m.trace_queries.main_states,
                        nodes_blob(m.trace_queries.query_proofs[0]))]
    if lay.num_aux_segments:
        tq.append(table_queries(m.trace_queries.aux_states,
                                nodes_blob(m.trace_queries.query_proofs[1])))
    cq = table_queries(m.constraint_queries.evaluations,
                       nodes_blob(m.constraint_queries.query_proof))

    cur = [_felt_val(x) for x in m.ood_frame.main_frame.current] + \
          [_felt_val(x) for x in m.ood_frame.aux_frame.current]
    nxt = [_felt_val(x) for x in m.ood_frame.main_frame.next] + \
          [_felt_val(x) for x in m.ood_frame.aux_frame.next]
    ood = OodFrame(trace_states=felts_to_bytes(cur + nxt),
                   evaluations=felts_to_bytes(
                       [_felt_val(x) for x in m.ood_frame.evaluations]))

    layers = []
    for l in m.fri_proof.layers:
        layers.append(FriProofLayer(
            values=b"".join(x.element for x in l.values),
            paths=nodes_blob(l.proofs)))
    fri = FriProof(layers=layers,
                   remainder=b"".join(x.element for x in m.fri_proof.remainder),
                   num_partitions=int(m.fri_proof.num_partitions))

    commitments = [bytes(d.data) for d in m.commitments.trace_roots]
    commitments.append(bytes(m.commitments.constraint_root.data))
    commitments += [bytes(d.data) for d in m.commitments.fri_roots]

    return StarkProof(context=ctx, commitments=commitments,
                      trace_queries=tq, constraint_queries=cq,
                      ood_frame=ood, fri_proof=fri,
                      pow_nonce=int(m.pow_nonce))
