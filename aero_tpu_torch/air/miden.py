"""Miden-compatible AIR: 72 main + 9 aux columns, 16 aux rand elements.

The counterpart of `aero_tpu/air/miden.py` (that module imports jax, so
its constants, constraints and aux builders are carried over here; a CPU
test holds each carried constant equal to the original). 112 transition
constraints and 46 boundary assertions over the aero-tpu VM trace
(`aero_tpu/vm/core/vm.cpp`); see the JAX module's docstring for the
constraint-by-constraint account.

The constraints are evaluated over (72, m) / (9, m) int64 tensors with the
field ops of `aero_tpu_torch.field`. The aux segment (overflow bus,
chiplet bus, ROM LogUp sum and ROM product) is built on the device: the
per-row bus factors, one batch inversion, and log-depth prefix scans.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from aero_tpu.spec import field as F
from aero_tpu.spec.proof import PublicInputs
from aero_tpu.vm import (COL_CLK, COL_G, COL_M, NUM_GROUPS, NUM_MEMBERS,
                         COL_IMM, COL_STACK, COL_PC, COL_OVF, COL_H0, COL_B1,
                         COL_E, COL_K, CH_CA, CH_CM, CH_CF, CH_CL, CH_C1,
                         CH_C2, CH_BITS, CH_ACC, CH_ACCZ, CH_SH, CH_P2, CH_CW,
                         CH_MA, CH_MCLK, CH_MV, CH_MW, CH_MG, CH_MD, OPS,
                         rom_listing, program_hash)

from ..field import (add, batch_inv, gf_cumprod, gf_cumsum, gf_full,
                     gf_zeros, mul, mul_scalar, scalar, sub)
from .air import Air, Assertion, TransitionDegree

OP = {name: i for i, name in enumerate(OPS)}
P = F.P

# chiplet block labels (must match vm.cpp)
L_RANGE4, L_AND, L_OR, L_XOR, L_SHL, L_SHR, L_MEM = 1, 2, 3, 4, 5, 6, 7
# pow2 product weights: p2 = prod_i (1 + sh_i * POW2_W[i])
POW2_W = [(1 << (1 << i)) - 1 for i in range(5)]
M32 = (1 << 32) - 1

# ops that shift the stack window down (new value enters at s0)
DOWN_OPS = ("push", "advpush", "dup0", "dup1", "dup2", "dup3", "dup4",
            "dup5", "dup6", "dup7")
# ops that shift the stack window up (top consumed/merged)
UP_OPS = ("drop", "add", "sub", "mul", "eq", "neq", "and", "or", "assert",
          "u32add", "u32sub", "u32mul", "u32div", "u32mod", "u32and",
          "u32or", "u32xor", "u32shl", "u32shr", "u32lt", "memstore")
# ops that leave slots j >= 1 unchanged
STAY_OPS = ("nop", "halt", "neg", "not", "inv", "eqz",
            "u32lo", "u32hi", "u32not", "memload")
# ops whose s0' is a free witness IN THE STACK CONSTRAINT — but every
# one except advpush (true nondeterminism: the advice tape) is pinned
# elsewhere: u32 results by the identity merge (constraint 46) plus the
# chiplet bus, memload by the memory chiplet bus.
NONDET_TOP_OPS = ("advpush", "u32lo", "u32hi", "u32not", "u32mul", "u32div",
                  "u32mod", "u32and", "u32or", "u32xor", "u32shl", "u32shr",
                  "u32lt", "memload")
# permutation ops: map j -> source slot (slots not listed stay)
PERM = {
    "swap": {0: 1, 1: 0},
    "movup2": {0: 2, 1: 0, 2: 1},
    "movup3": {0: 3, 1: 0, 2: 1, 3: 2},
    "movup4": {0: 4, 1: 0, 2: 1, 3: 2, 4: 3},
    "movdn2": {0: 1, 1: 2, 2: 0},
    "movdn3": {0: 1, 1: 2, 2: 3, 3: 0},
    "movdn4": {0: 1, 1: 2, 2: 3, 3: 4, 4: 0},
}
# h0 witness users (constraint 37 forces h0 = 0 everywhere else)
H0_USERS = ("eq", "neq", "eqz", "inv", "u32add", "u32sub", "u32mul",
            "u32div", "u32mod", "u32lo", "u32hi", "u32lt", "u32shl",
            "u32shr")


class MidenAir(Air):
    main_width = 72
    aux_width = 9
    aux_rands = 16

    def __init__(self, trace_length: int, pub_inputs, options,
                 program: Optional[str] = None):
        """`program` is the assembly source (REQUIRED): (a) its blake2s
        hash is checked against PublicInputs.program_hash, and (b) the
        ROM static-product boundary (aux3[n-1]) and the completion-pc
        boundary are computed from the assembled listing — the
        program-aware binding."""
        super().__init__(trace_length, pub_inputs, options)
        if program is None:
            raise ValueError(
                "MidenAir requires the program source: the ROM boundary "
                "(aux3[n-1]) and completion pc are recomputed from it")
        self.program = program
        self._aux_rand: Optional[Sequence[int]] = None
        if list(program_hash(program)) != list(pub_inputs.program_hash):
            raise ValueError(
                "program_hash mismatch: the supplied program is not "
                "the one claimed by PublicInputs")
        self._rom = rom_listing(program)

    @property
    def ce_blowup(self) -> int:
        # fixed at 8 for golden-vector shape compatibility (8 OOD
        # columns), matching the max constraint degree
        return 8

    def transition_degrees(self) -> List[TransitionDegree]:
        degs = [TransitionDegree(1)]                      # 0 clk
        degs += [TransitionDegree(2)] * 14                # 1-14 booleanity
        degs += [TransitionDegree(1)] * 2                 # 15-16 one-hot
        degs += [TransitionDegree(4)] * 16                # 17-32 stack
        degs += [TransitionDegree(5)]                     # 33 inv witness
        degs += [TransitionDegree(3)]                     # 34 assert
        degs += [TransitionDegree(4)] * 2                 # 35-36 bool inputs
        degs += [TransitionDegree(3)]                     # 37 h0 hygiene
        degs += [TransitionDegree(4)]                     # 38 pc update
        degs += [TransitionDegree(2)]                     # 39 ovf counter
        degs += [TransitionDegree(5)]                     # 40 overflow bus
        degs += [TransitionDegree(4)]                     # 41 b1 update
        degs += [TransitionDegree(2)] * 2                 # 42-43 e/k
        degs += [TransitionDegree(4)]                     # 44 empty pop
        degs += [TransitionDegree(5)]                     # 45 branch bool
        degs += [TransitionDegree(4)]                     # 46 u32 identities
        degs += [TransitionDegree(4)]                     # 47 lt booleanity
        degs += [TransitionDegree(8)]                     # 48 chiplet bus
        degs += [TransitionDegree(7)]                     # 49 ROM LogUp
        degs += [TransitionDegree(5)]                     # 50 ROM product
        degs += [TransitionDegree(2)] * 5                 # 51-55 flags
        degs += [TransitionDegree(3)] * 16                # 56-71 value bits
        degs += [TransitionDegree(3)] * 5                 # 72-76 sh bits
        degs += [TransitionDegree(3)] * 5                 # 77-81 sh const
        degs += [TransitionDegree(2)]                     # 82 CW init
        degs += [TransitionDegree(3)]                     # 83 CW step
        degs += [TransitionDegree(3)]                     # 84 continuity
        degs += [TransitionDegree(2)] * 4                 # 85-88 acc init
        degs += [TransitionDegree(3)] * 4                 # 89-92 acc step
        degs += [TransitionDegree(4)]                     # 93 accz init
        degs += [TransitionDegree(5)]                     # 94 accz step
        degs += [TransitionDegree(3)] * 4                 # 95-98 constancy
        degs += [TransitionDegree(6)]                     # 99 p2 formula
        degs += [TransitionDegree(3)]                     # 100 block length
        degs += [TransitionDegree(3)] * 2                 # 101-102 mem flags
        degs += [TransitionDegree(4)]                     # 103 same addr
        degs += [TransitionDegree(5)]                     # 104 read consist
        degs += [TransitionDegree(5)]                     # 105 fresh read 0
        degs += [TransitionDegree(4)]                     # 106 md binding
        degs += [TransitionDegree(5)] * 2                 # 107-108 canonical
        degs += [TransitionDegree(3)]                     # 109 CA phase
        degs += [TransitionDegree(4)]                     # 110 CM phase
        degs += [TransitionDegree(4)]                     # 111 CR boolean
        assert len(degs) == 112
        return degs

    # ------------------------------------------------------------ assertions

    def _rom_product(self) -> int:
        """Expected aux3[n-1]: prod over the assembled program listing of
        (alpha - (pc + beta*op + beta^2*imm)). The verifier computes this
        from the program source itself — the committed ROM chiplet rows
        must multiply out to the same value, which (as a polynomial
        identity in alpha) forces their (pc, op, imm) multiset to equal
        the listing's."""
        if self._aux_rand is None:
            return 0   # placeholder until the aux rands are drawn:
                       # len(get_assertions()) must not change
        alpha = int(self._aux_rand[10]) % P
        beta = int(self._aux_rand[11]) % P
        acc = 1
        for pc, op, imm in self._rom:
            b = (pc + beta * op + beta * beta % P * imm) % P
            acc = acc * ((alpha - b) % P) % P
        return acc

    def _overflow_product(self) -> int:
        """Expected aux0[n-1]: the product of the UNMATCHED insert
        factors — one per row still in the overflow table at the end,
        (r12 + r13*addr + r14*val + r15*prev_addr). The verifier
        recomputes it from the claimed final table (addresses in
        PublicInputs.overflow_addrs newest-first, parked values in
        output_stack[16:] newest-first); as a polynomial identity in
        the rands this pins the committed table's multiset of
        (addr, val, prev) triples, and the b1[n-1] assertion pins the
        LIFO top, determining the whole linked list. Empty table -> 1
        (the old always-drained boundary). Reference analog:
        ProgramOutputs.overflow_addrs
        (miden-proof-generator/src/main.rs:35-38)."""
        if self._aux_rand is None:
            return 1   # placeholder until the aux rands are drawn
        r = self._aux_rand
        addrs = [int(a) % P for a in self.pub_inputs.overflow_addrs]
        vals = [int(v) % P for v in self.pub_inputs.output_stack[16:]]
        if len(addrs) != len(vals):
            raise ValueError(
                "overflow_addrs and output_stack[16:] (parked values) "
                "must pair up one-to-one")
        acc, prev = 1, 0
        for a, v in zip(reversed(addrs), reversed(vals)):  # bottom-first
            acc = acc * ((r[12] + r[13] * a + r[14] * v
                          + r[15] * prev) % P) % P
            prev = a
        return acc

    def get_assertions(self) -> List[Assertion]:
        """All 16 input and output stack slots are bound (the golden
        7-assertion shape bound only a prefix — reference binds full
        outputs, miden-proof-generator/src/main.rs:35-38), plus the
        program-counter boundaries (start at pc=0, finish at the halt
        entry — no sub-segment of the program can be proven), the
        chiplet row-0 inactivity anchors, the final overflow-table top
        (b1[n-1]) and the four bus boundaries. 46 assertions total; the
        aux0 and aux3 boundary values are rand-dependent (set via
        _aux_rand by the prover / verifier before composition)."""
        n = self.trace_length
        pub = self.pub_inputs
        # stack_inputs are serialized bottom-first in the golden encoding;
        # reverse to get the top-first execution view
        top_in = (list(reversed(pub.stack_inputs)) + [0] * 16)[:16]
        out = (list(pub.output_stack) + [0] * 16)[:16]
        ovf_addrs = list(pub.overflow_addrs)
        asserts = [Assertion(COL_CLK, 0, 0),
                   # execution starts at the program head and reaches the
                   # halt entry (the last ROM entry) — together with the
                   # pc-update chain this forbids proving a sub-segment
                   Assertion(COL_PC, 0, 0),
                   Assertion(COL_PC, n - 1, len(self._rom) - 1),
                   # chiplet regions start at row 1: anchors the block
                   # first-row init and memory fresh-read constraints
                   Assertion(CH_CA, 0, 0),
                   Assertion(CH_CM, 0, 0),
                   # the final overflow-table top address (0 if empty)
                   Assertion(COL_B1, n - 1,
                             int(ovf_addrs[0]) if ovf_addrs else 0)]
        for j in range(16):
            asserts.append(Assertion(COL_STACK + j, 0, top_in[j]))
            asserts.append(Assertion(COL_STACK + j, n - 1, out[j]))
        asserts += [
            # overflow bus: empty at the start, bound to the claimed
            # final table at the end (1 when it drains)
            Assertion(72, 0, 1, is_aux=True),
            Assertion(72, n - 1, self._overflow_product(), is_aux=True),
            # chiplet bus: every request answered
            Assertion(73, 0, 1, is_aux=True),
            Assertion(73, n - 1, 1, is_aux=True),
            # ROM LogUp: row ops balance against ROM multiplicities
            Assertion(74, 0, 0, is_aux=True),
            Assertion(74, n - 1, 0, is_aux=True),
            # ROM static product: committed ROM = assembled program
            Assertion(75, 0, 1, is_aux=True),
            Assertion(75, n - 1, self._rom_product(), is_aux=True),
        ]
        return asserts


    # ------------------------------------------------------------ constraints

    def evaluate_transitions(self, main_cur, main_nxt, aux_cur, aux_nxt,
                             aux_rand: Sequence[int]) -> List[torch.Tensor]:
        m = main_cur.shape[-1]
        device = main_cur.device

        def zeros():
            return gf_zeros((m,), device)

        def konst(v):
            return gf_full((m,), v % P, device)

        one = konst(1)

        def c(i):
            return main_cur[i]

        def nx(i):
            return main_nxt[i]

        g_sel = [c(COL_G + i) for i in range(NUM_GROUPS)]
        m_sel = [c(COL_M + i) for i in range(NUM_MEMBERS)]
        flag = {name: mul(g_sel[i // 8], m_sel[i % 8])
                for i, name in enumerate(OPS)}
        s = [c(COL_STACK + j) for j in range(16)]
        sn = [nx(COL_STACK + j) for j in range(16)]
        imm = c(COL_IMM)
        h0 = c(COL_H0)
        pc = c(COL_PC)
        clk = c(COL_CLK)

        out: List[torch.Tensor] = []
        # 0: clk
        out.append(sub(nx(COL_CLK), add(clk, one)))
        # 1-14: booleanity
        for sel in g_sel + m_sel:
            out.append(sub(mul(sel, sel), sel))
        # 15-16: one-hot sums
        for sels in (g_sel, m_sel):
            total = zeros()
            for sel in sels:
                total = add(total, sel)
            out.append(sub(total, one))

        # per-op top-of-stack results
        d01 = sub(s[0], s[1])
        dh = mul(d01, h0)            # 1 iff s0 != s1 (witnessed)
        zh = mul(s[0], h0)           # 1 iff s0 != 0 (witnessed)
        s0s1 = mul(s[0], s[1])
        two32 = konst(1 << 32)
        top_result = {
            "nop": s[0], "halt": s[0],
            "push": imm, "drop": s[1],
            "add": add(s[0], s[1]), "sub": sub(s[1], s[0]),
            "mul": s0s1, "neg": sub(zeros(), s[0]),
            "eq": sub(one, dh), "neq": dh,
            "eqz": sub(one, zh), "inv": h0,
            "not": sub(one, s[0]),
            "and": s0s1, "or": sub(add(s[0], s[1]), s0s1),
            "assert": s[1],
            # u32 wrap-around, exact via h0 carry/borrow (operands are
            # range-checked over the chiplet bus, so the result is a
            # sound u32):
            #   u32add: s0' = a + b - carry*2^32   (a=s1, b=s0)
            #   u32sub: s0' = a - b + borrow*2^32
            "u32add": sub(add(s[0], s[1]), mul(h0, two32)),
            "u32sub": add(sub(s[1], s[0]), mul(h0, two32)),
            "memstore": s[1],   # pop addr; stored value stays on top
        }
        for k in range(8):
            top_result[f"dup{k}"] = s[k]
        for name in NONDET_TOP_OPS:
            top_result[name] = sn[0]    # pinned by constraint 46 / buses

        # 17-32: stack updates (class-flag collapse, see DOWN/UP/STAY)
        def class_flag(names):
            f = zeros()
            for nm in names:
                f = add(f, flag[nm])
            return f

        down_f = class_flag(DOWN_OPS)
        up_f = class_flag(UP_OPS)
        stay_f = class_flag(STAY_OPS)

        for j in range(16):
            if j == 0:
                expr = zeros()
                for name in OPS:
                    src0 = (s[PERM[name][0]] if name in PERM
                            else top_result[name])
                    expr = add(expr, mul(flag[name], src0))
            else:
                expr = mul(down_f, s[j - 1])
                expr = add(expr, mul(up_f, s[j + 1] if j < 15 else sn[15]))
                expr = add(expr, mul(stay_f, s[j]))
                for name, perm in PERM.items():
                    expr = add(expr, mul(flag[name], s[perm.get(j, j)]))
            out.append(sub(sn[j], expr))

        # 33: inverse-witness soundness (flag-exclusive merge)
        w = mul(mul(add(flag["eq"], flag["neq"]), d01), sub(one, dh))
        w = add(w, mul(mul(flag["eqz"], s[0]), sub(one, zh)))
        w = add(w, mul(flag["inv"], sub(zh, one)))
        carry_ops = add(flag["u32add"], flag["u32sub"])
        w = add(w, mul(carry_ops, mul(h0, sub(h0, one))))
        out.append(w)
        # 34: assert pops a 1
        out.append(mul(flag["assert"], sub(s[0], one)))
        # 35-36: boolean inputs for logic ops
        logic0 = add(add(flag["and"], flag["or"]), flag["not"])
        out.append(mul(mul(logic0, s[0]), sub(s[0], one)))
        logic1 = add(flag["and"], flag["or"])
        out.append(mul(mul(logic1, s[1]), sub(s[1], one)))
        # 37: h0 hygiene — zero outside its witnessing ops
        users = zeros()
        for nm in H0_USERS:
            users = add(users, flag[nm])
        out.append(mul(sub(one, users), h0))
        # 38: pc update. Normal: pc'=pc+1. Branch drop: pc' = cond?pc+1:imm
        # (ordinary drops have imm=pc+1, making the deviation vanish).
        # Jump nop: pc'=imm (ordinary nops also have imm=pc+1). Halt: pc
        # frozen.
        dev = sub(imm, add(pc, one))
        expr = add(pc, one)
        expr = add(expr, mul(mul(flag["drop"], sub(one, s[0])), dev))
        expr = add(expr, mul(flag["nop"], dev))
        expr = sub(expr, flag["halt"])
        out.append(sub(nx(COL_PC), expr))
        # 39: overflow net counter
        out.append(sub(nx(COL_OVF), sub(add(c(COL_OVF), down_f), up_f)))

        # rand elements as 0-d tensors (they broadcast over the domain)
        g = [scalar(r, device) for r in aux_rand]

        # 40: overflow-table multiset bus on aux0 (rands 12-15) — see
        # push_shift/pop_shift in vm.cpp
        b1 = c(COL_B1)
        bn1 = nx(COL_B1)
        e = c(COL_E)
        kinv = c(COL_K)
        l_ins = add(add(g[12], mul(g[13], add(clk, one))),
                    add(mul(g[14], s[15]), mul(g[15], b1)))
        l_del = add(add(g[12], mul(g[13], b1)),
                    add(mul(g[14], sn[15]), mul(g[15], bn1)))
        ins_f = add(one, mul(down_f, sub(l_ins, one)))
        pop_f = mul(up_f, sub(one, e))      # pop from a non-empty table
        del_f = add(one, mul(pop_f, sub(l_del, one)))
        out.append(sub(mul(aux_nxt[0], del_f), mul(aux_cur[0], ins_f)))
        # 41: b1 bookkeeping
        c_b1 = mul(down_f, sub(bn1, add(clk, one)))
        c_b1 = add(c_b1, mul(mul(up_f, e), bn1))
        c_b1 = add(c_b1, mul(sub(one, add(down_f, up_f)), sub(bn1, b1)))
        out.append(c_b1)
        # 42-43: emptiness flag soundness: e=1 <=> b1=0
        out.append(mul(e, b1))
        out.append(sub(mul(b1, kinv), sub(one, e)))
        # 44: pop from an EMPTY table refills s15 with 0
        out.append(mul(mul(up_f, e), sn[15]))

        # 45: branch-condition booleanity — active exactly on drop rows
        # whose imm deviates from pc+1 (i.e. compiled branches)
        out.append(mul(mul(mul(flag["drop"], s[0]), sub(s[0], one)), dev))

        # 46: u32 algebraic identities (flag-exclusive merge; the values
        # they reference are range-certified by the chiplet bus)
        m32c = konst(M32)
        ident = mul(flag["u32mul"],
                    sub(mul(s[1], s[0]), add(mul(h0, two32), sn[0])))
        ident = add(ident, mul(flag["u32div"],
                               sub(s[1], add(mul(s[0], sn[0]), h0))))
        ident = add(ident, mul(flag["u32mod"],
                               sub(s[1], add(mul(s[0], h0), sn[0]))))
        ident = add(ident, mul(flag["u32not"],
                               sub(add(sn[0], s[0]), m32c)))
        ident = add(ident, mul(flag["u32lo"],
                               sub(s[0], add(mul(h0, two32), sn[0]))))
        ident = add(ident, mul(flag["u32hi"],
                               sub(s[0], add(mul(sn[0], two32), h0))))
        lt_w = add(mul(sn[0], sub(sub(s[0], one), s[1])),
                   mul(sub(one, sn[0]), sub(s[1], s[0])))
        ident = add(ident, mul(flag["u32lt"], sub(lt_w, h0)))
        ident = add(ident, mul(flag["u32shl"],
                               sub(mul(s[1], imm), add(mul(h0, two32),
                                                       sn[0]))))
        ident = add(ident, mul(flag["u32shr"],
                               sub(s[1], add(mul(sn[0], imm), h0))))
        out.append(ident)
        # 47: u32lt result booleanity
        out.append(mul(mul(flag["u32lt"], sn[0]), sub(sn[0], one)))

        # ---- chiplet columns ----
        ca, cm, cf = c(CH_CA), c(CH_CM), c(CH_CF)
        can, cfn, cmn = nx(CH_CA), nx(CH_CF), nx(CH_CM)
        cl, c1, c2 = c(CH_CL), c(CH_C1), c(CH_C2)
        accs = [c(CH_ACC + k) for k in range(4)]
        accz = c(CH_ACCZ)
        shb = [c(CH_SH + t) for t in range(5)]
        p2 = c(CH_P2)
        cw = c(CH_CW)
        bits = [[c(CH_BITS + 4 * k + t) for t in range(4)] for k in range(4)]
        ma, mclk, mv, mw, mg = (c(CH_MA), c(CH_MCLK), c(CH_MV),
                                c(CH_MW), c(CH_MG))
        man, mclkn, mvn, mwn = (nx(CH_MA), nx(CH_MCLK), nx(CH_MV),
                                nx(CH_MW))

        # 48: chiplet bus — requests (main rows + memory sortedness) vs
        # responses (block last rows + memory rows)
        def lin(label, v1=None, v2=None, v3=None, v4=None, sh=None,
                p2v=None, z=None, c1v=None, c2v=None):
            t = mul_scalar(g[0], label) if label != 1 else g[0]
            for coeff, val in ((1, v1), (2, v2), (3, v3), (4, v4),
                               (5, sh), (6, p2v), (7, z), (8, c1v),
                               (9, c2v)):
                if val is not None:
                    t = add(t, mul(g[coeff], val))
            return t

        msgs = {
            # the RESULT sn[0] rides the add/sub request: range-checked,
            # it pins the carry/borrow h0 (result = a+b-carry*2^32 with
            # a forged carry lands outside [0, 2^32))
            "u32add": lin(L_RANGE4, s[1], s[0], sn[0], p2v=one),
            "u32sub": lin(L_RANGE4, s[1], s[0], sn[0], p2v=one),
            "u32mul": lin(L_RANGE4, s[1], s[0], h0, sn[0], p2v=one),
            "u32not": lin(L_RANGE4, s[0], sn[0], p2v=one),
            "u32lo": lin(L_RANGE4, h0, sn[0], p2v=one),
            "u32hi": lin(L_RANGE4, sn[0], h0, p2v=one),
            "u32lt": lin(L_RANGE4, h0, s[1], s[0], p2v=one),
            "u32and": lin(L_AND, s[1], s[0], p2v=one, z=sn[0],
                          c2v=one),
            "u32or": lin(L_OR, s[1], s[0], p2v=one, z=sn[0],
                         c1v=one, c2v=konst(P - 1)),
            "u32xor": lin(L_XOR, s[1], s[0], p2v=one, z=sn[0],
                          c1v=one, c2v=konst(P - 2)),
            "u32shl": lin(L_SHL, s[1], h0, sn[0], sh=s[0], p2v=imm),
            "u32shr": lin(L_SHR, s[1], sn[0], h0,
                          sub(sub(imm, one), h0), sh=s[0], p2v=imm),
            "memload": lin(L_MEM, s[0], clk, sn[0]),
            "memstore": lin(L_MEM, s[0], clk, sn[0], one),
        }
        req = one
        for name, msg in msgs.items():
            req = add(req, mul(flag[name], sub(msg, one)))
        # u32div/u32mod post TWO requests (product of messages): the
        # (b, q, r, b-1-r) block plus a dividend range check — without
        # the latter the AIR would accept non-u32 dividends the VM's
        # checked semantics trap on
        dividend_msg = lin(L_RANGE4, s[1], p2v=one)
        div_msg = lin(L_RANGE4, s[0], sn[0], h0,
                      sub(sub(s[0], one), h0), p2v=one)
        mod_msg = lin(L_RANGE4, s[0], h0, sn[0],
                      sub(sub(s[0], one), sn[0]), p2v=one)
        req = add(req, mul(flag["u32div"],
                           sub(mul(div_msg, dividend_msg), one)))
        req = add(req, mul(flag["u32mod"],
                           sub(mul(mod_msg, dividend_msg), one)))
        # memory sortedness request (rides the same bus); the diff is the
        # MATERIALIZED md column — bound to the (addr, clk) deltas by
        # constraint 106 — keeping this factor at degree 3
        md = c(CH_MD)
        sort_msg = lin(L_RANGE4, md, ma, p2v=one)
        req = mul(req, add(one, mul(mul(cm, cmn), sub(sort_msg, one))))
        # responses
        shval = zeros()
        for t in range(5):
            shval = add(shval, mul_scalar(shb[t], 1 << t))
        # block response: label comes from the CL column
        resp_bits = mul(g[0], cl)
        for coeff, val in ((1, accs[0]), (2, accs[1]), (3, accs[2]),
                           (4, accs[3]), (5, shval), (6, p2), (7, accz),
                           (8, c1), (9, c2)):
            resp_bits = add(resp_bits, mul(g[coeff], val))
        last = mul(ca, add(sub(one, can), cfn))
        resp_mem = lin(L_MEM, ma, mclk, mv, mw)
        resp = add(one, mul(last, sub(resp_bits, one)))
        resp = add(resp, mul(cm, sub(resp_mem, one)))
        out.append(sub(mul(aux_nxt[1], resp), mul(aux_cur[1], req)))

        # 49: program-ROM LogUp on aux2:
        #   S' = S + 1/(alpha - a) - CRa*mult/(alpha - b)
        # cleared of denominators. a = pc + beta*op + beta^2*imm*u with
        # u = push|drop|nop (shift rows reuse imm as the p2 helper).
        alpha, beta = g[10], g[11]
        beta2 = mul(beta, beta)
        openc = zeros()
        for i in range(NUM_GROUPS):
            openc = add(openc, mul_scalar(g_sel[i], 8 * i))
        for j in range(NUM_MEMBERS):
            openc = add(openc, mul_scalar(m_sel[j], j))
        uimm = add(add(flag["push"], flag["drop"]), flag["nop"])
        a_val = add(pc, add(mul(beta, openc), mul(mul(beta2, imm), uimm)))
        cr = ma   # CR flag shares the memory-addr column (disjoint rows)
        cra = mul(mul(sub(one, ca), sub(one, cm)), cr)
        b_val = add(mclk, add(mul(beta, mv), mul(beta2, mw)))
        da = sub(alpha, a_val)
        db = sub(alpha, b_val)
        s_diff = sub(aux_nxt[2], aux_cur[2])
        logup = sub(mul(mul(s_diff, da), db), db)
        logup = add(logup, mul(mul(cra, mg), da))   # mg column = mult here
        out.append(logup)

        # 50: ROM static product on aux3
        prod_f = add(one, mul(cra, sub(db, one)))
        out.append(sub(aux_nxt[3], mul(aux_cur[3], prod_f)))

        # 51-55: chiplet activity flags
        out.append(sub(mul(ca, ca), ca))
        out.append(sub(mul(cm, cm), cm))
        out.append(sub(mul(cf, cf), cf))
        out.append(mul(cf, sub(one, ca)))
        out.append(mul(ca, cm))
        # 56-71: value-bit booleanity (CA-gated)
        for k in range(4):
            for t in range(4):
                b = bits[k][t]
                out.append(mul(ca, mul(b, sub(b, one))))
        # 72-76: shift-bit booleanity
        for t in range(5):
            out.append(mul(ca, mul(shb[t], sub(shb[t], one))))
        # cont: next row continues this block
        cont = mul(can, sub(one, cfn))
        # 77-81: shift-bit constancy
        for t in range(5):
            out.append(mul(cont, sub(nx(CH_SH + t), shb[t])))
        # 82-83: CW init/step
        out.append(mul(cf, sub(cw, one)))
        out.append(mul(cont, sub(nx(CH_CW), mul_scalar(cw, 16))))
        # 84: block continuity — a continuing row must follow a block row
        out.append(mul(sub(one, ca), cont))
        # 85-92: acc init/step

        def nib(k, frame):
            t = zeros()
            for j in range(4):
                t = add(t, mul_scalar(frame[k][j], 1 << j))
            return t

        bits_nxt = [[nx(CH_BITS + 4 * k + t) for t in range(4)]
                    for k in range(4)]
        for k in range(4):
            out.append(mul(cf, sub(accs[k], nib(k, bits))))
        for k in range(4):
            out.append(mul(cont, sub(nx(CH_ACC + k),
                                     add(mul_scalar(accs[k], 16),
                                         nib(k, bits_nxt)))))
        # 93-94: accz init/step: z_bit = c1*(a+b) + c2*a*b

        def znib(frame, c1v, c2v):
            t = zeros()
            for j in range(4):
                zb = add(mul(c1v, add(frame[0][j], frame[1][j])),
                         mul(c2v, mul(frame[0][j], frame[1][j])))
                t = add(t, mul_scalar(zb, 1 << j))
            return t

        out.append(mul(cf, sub(accz, znib(bits, c1, c2))))
        out.append(mul(cont, sub(nx(CH_ACCZ),
                                 add(mul_scalar(accz, 16),
                                     znib(bits_nxt, nx(CH_C1),
                                          nx(CH_C2))))))
        # 95-98: CL/C1/C2/p2 constancy
        for col in (CH_CL, CH_C1, CH_C2, CH_P2):
            out.append(mul(cont, sub(nx(col), c(col))))
        # 99: p2 formula on first rows
        prod = one
        for t in range(5):
            prod = mul(prod, add(one, mul_scalar(shb[t], POW2_W[t])))
        out.append(mul(cf, sub(p2, prod)))
        # 100: exactly-8-row blocks: the response row must carry CW=16^7
        out.append(mul(last, sub(cw, konst(16 ** 7))))
        # 101-105: memory chiplet
        out.append(mul(cm, mul(mw, sub(mw, one))))
        out.append(mul(cm, mul(mg, sub(mg, one))))
        gate = mul(cm, cmn)
        out.append(mul(mul(gate, mg), sub(man, ma)))
        out.append(mul(mul(mul(gate, mg), sub(one, mwn)),
                       sub(mvn, mv)))
        out.append(mul(mul(mul(cmn, sub(one, mul(cm, mg))),
                           sub(one, mwn)), mvn))
        # 106: md binding — the materialized sortedness diff equals the
        # (clk or addr) delta minus one on adjacent memory rows
        diff = add(mul(mg, sub(sub(mclkn, mclk), one)),
                   mul(sub(one, mg), sub(sub(man, ma), one)))
        out.append(mul(gate, sub(md, diff)))
        # 107-108: canonical u32lo/u32hi split. Since 2^64-2^32 === -1
        # (mod p), (hi = 2^32-1, lo = x+1) is a second valid split of x;
        # exclude it: z = 1 - (hi - (2^32-1))*imm is 1 exactly when
        # hi = 2^32-1 (imm carries the inverse witness otherwise), and
        # then lo is forced to 0.
        d_lo = sub(h0, m32c)       # u32lo rows: hi = h0, lo = sn[0]
        d_hi = sub(sn[0], m32c)    # u32hi rows: hi = sn[0], lo = h0
        z_lo = sub(one, mul(d_lo, imm))
        z_hi = sub(one, mul(d_hi, imm))
        out.append(add(mul(flag["u32lo"], mul(d_lo, z_lo)),
                       mul(flag["u32hi"], mul(d_hi, z_hi))))
        out.append(add(mul(flag["u32lo"], mul(sn[0], z_lo)),
                       mul(flag["u32hi"], mul(h0, z_hi))))
        # 109: bits-region contiguity — CA may only turn on across the
        # row-0 transition (clk = row index, nonzero for rows >= 1);
        # with CH_CA[0] = 0 asserted, the region is one prefix run and
        # every block entry passes through the CF init constraints
        out.append(mul(mul(clk, can), sub(one, ca)))
        # 110: memory-region contiguity — CM may only turn on at row 1
        # or directly after a bits-chiplet row, so memory rows form one
        # contiguous run and constraint 105's "fresh address" gating
        # cannot be reset by splitting runs
        out.append(mul(mul(mul(clk, cmn), sub(one, cm)), sub(one, ca)))
        # 111: ROM-row CR flag booleanity (aux3's product factors must
        # be monic in alpha)
        out.append(mul(mul(mul(sub(one, ca), sub(one, cm)), cr),
                       sub(cr, one)))

        assert len(out) == 112
        return out

    # ------------------------------------------------------------- aux trace

    def build_aux_trace(self, main_trace: torch.Tensor,
                        aux_rand: Sequence[int]) -> torch.Tensor:
        """aux0 = overflow bus; aux1 = chiplet bus; aux2 = ROM LogUp sum;
        aux3 = ROM static product; aux4-aux8 = zero padding (the aux width
        stays 9 for golden-shape compatibility). Built on the device of
        `main_trace` (`aero_tpu`'s `build_aux_trace_host` is the oracle the
        tests hold it against)."""
        self._aux_rand = [int(r) % P for r in aux_rand]
        g = [scalar(r, main_trace.device) for r in self._aux_rand]
        nxt = torch.roll(main_trace, -1, dims=-1)
        return _aux_scans(*_bus_row_factors(main_trace, nxt, g))


# ------------------------------------------------- device-side aux builders

def _bus_row_factors(cur: torch.Tensor, nxt: torch.Tensor,
                     g: List[torch.Tensor]):
    """Per-row bus factors off the committed trace columns, vectorized
    over all n rows at once. The expressions MUST mirror the transition
    constraints 40/48/49/50 in MidenAir.evaluate_transitions — any drift
    makes proofs fail verification (and trips the host-oracle equality
    test). Returns (ins_f, del_f, req, resp, da, db, lgnum, prod_f)."""
    m = cur.shape[-1]
    device = cur.device

    def zeros():
        return gf_zeros((m,), device)

    def konst(v):
        return gf_full((m,), v % P, device)

    one = konst(1)

    def c(i):
        return cur[i]

    def nx(i):
        return nxt[i]

    g_sel = [c(COL_G + i) for i in range(NUM_GROUPS)]
    m_sel = [c(COL_M + i) for i in range(NUM_MEMBERS)]
    flag = {name: mul(g_sel[i // 8], m_sel[i % 8])
            for i, name in enumerate(OPS)}
    s = [c(COL_STACK + j) for j in range(16)]
    sn = [nx(COL_STACK + j) for j in range(16)]
    imm, h0, pc, clk = c(COL_IMM), c(COL_H0), c(COL_PC), c(COL_CLK)

    def class_flag(names):
        f = zeros()
        for nm in names:
            f = add(f, flag[nm])
        return f

    down_f = class_flag(DOWN_OPS)
    up_f = class_flag(UP_OPS)

    # overflow bus factors (constraint 40)
    b1, bn1, e = c(COL_B1), nx(COL_B1), c(COL_E)
    l_ins = add(add(g[12], mul(g[13], add(clk, one))),
                add(mul(g[14], s[15]), mul(g[15], b1)))
    l_del = add(add(g[12], mul(g[13], b1)),
                add(mul(g[14], sn[15]), mul(g[15], bn1)))
    ins_f = add(one, mul(down_f, sub(l_ins, one)))
    pop_f = mul(up_f, sub(one, e))
    del_f = add(one, mul(pop_f, sub(l_del, one)))

    # chiplet bus factors (constraint 48)
    ca, cm, cf = c(CH_CA), c(CH_CM), c(CH_CF)
    can, cfn, cmn = nx(CH_CA), nx(CH_CF), nx(CH_CM)
    cl, c1, c2 = c(CH_CL), c(CH_C1), c(CH_C2)
    accs = [c(CH_ACC + k) for k in range(4)]
    accz = c(CH_ACCZ)
    shb = [c(CH_SH + t) for t in range(5)]
    p2, cw = c(CH_P2), c(CH_CW)
    ma, mclk, mv, mw, mg, md = (c(CH_MA), c(CH_MCLK), c(CH_MV),
                                c(CH_MW), c(CH_MG), c(CH_MD))

    def lin(label, v1=None, v2=None, v3=None, v4=None, sh=None,
            p2v=None, z=None, c1v=None, c2v=None):
        t = mul_scalar(g[0], label) if label != 1 else g[0]
        for coeff, val in ((1, v1), (2, v2), (3, v3), (4, v4),
                           (5, sh), (6, p2v), (7, z), (8, c1v),
                           (9, c2v)):
            if val is not None:
                t = add(t, mul(g[coeff], val))
        return t

    msgs = {
        "u32add": lin(L_RANGE4, s[1], s[0], sn[0], p2v=one),
        "u32sub": lin(L_RANGE4, s[1], s[0], sn[0], p2v=one),
        "u32mul": lin(L_RANGE4, s[1], s[0], h0, sn[0], p2v=one),
        "u32not": lin(L_RANGE4, s[0], sn[0], p2v=one),
        "u32lo": lin(L_RANGE4, h0, sn[0], p2v=one),
        "u32hi": lin(L_RANGE4, sn[0], h0, p2v=one),
        "u32lt": lin(L_RANGE4, h0, s[1], s[0], p2v=one),
        "u32and": lin(L_AND, s[1], s[0], p2v=one, z=sn[0], c2v=one),
        "u32or": lin(L_OR, s[1], s[0], p2v=one, z=sn[0],
                     c1v=one, c2v=konst(P - 1)),
        "u32xor": lin(L_XOR, s[1], s[0], p2v=one, z=sn[0],
                      c1v=one, c2v=konst(P - 2)),
        "u32shl": lin(L_SHL, s[1], h0, sn[0], sh=s[0], p2v=imm),
        "u32shr": lin(L_SHR, s[1], sn[0], h0,
                      sub(sub(imm, one), h0), sh=s[0], p2v=imm),
        "memload": lin(L_MEM, s[0], clk, sn[0]),
        "memstore": lin(L_MEM, s[0], clk, sn[0], one),
    }
    req = one
    for name, msg in msgs.items():
        req = add(req, mul(flag[name], sub(msg, one)))
    dividend_msg = lin(L_RANGE4, s[1], p2v=one)
    div_msg = lin(L_RANGE4, s[0], sn[0], h0,
                  sub(sub(s[0], one), h0), p2v=one)
    mod_msg = lin(L_RANGE4, s[0], h0, sn[0],
                  sub(sub(s[0], one), sn[0]), p2v=one)
    req = add(req, mul(flag["u32div"], sub(mul(div_msg, dividend_msg), one)))
    req = add(req, mul(flag["u32mod"], sub(mul(mod_msg, dividend_msg), one)))
    sort_msg = lin(L_RANGE4, md, ma, p2v=one)
    req = mul(req, add(one, mul(mul(cm, cmn), sub(sort_msg, one))))

    shval = zeros()
    for t in range(5):
        shval = add(shval, mul_scalar(shb[t], 1 << t))
    resp_bits = mul(g[0], cl)
    for coeff, val in ((1, accs[0]), (2, accs[1]), (3, accs[2]),
                       (4, accs[3]), (5, shval), (6, p2), (7, accz),
                       (8, c1), (9, c2)):
        resp_bits = add(resp_bits, mul(g[coeff], val))
    last = mul(ca, add(sub(one, can), cfn))
    resp_mem = lin(L_MEM, ma, mclk, mv, mw)
    resp = add(one, mul(last, sub(resp_bits, one)))
    resp = add(resp, mul(cm, sub(resp_mem, one)))

    # ROM LogUp / static product factors (constraints 49-50)
    alpha, beta = g[10], g[11]
    beta2 = mul(beta, beta)
    openc = zeros()
    for i in range(NUM_GROUPS):
        openc = add(openc, mul_scalar(g_sel[i], 8 * i))
    for j in range(NUM_MEMBERS):
        openc = add(openc, mul_scalar(m_sel[j], j))
    uimm = add(add(flag["push"], flag["drop"]), flag["nop"])
    a_val = add(pc, add(mul(beta, openc), mul(mul(beta2, imm), uimm)))
    cra = mul(mul(sub(one, ca), sub(one, cm)), ma)
    b_val = add(mclk, add(mul(beta, mv), mul(beta2, mw)))
    da = sub(alpha, a_val)
    db = sub(alpha, b_val)
    lgnum = mul(cra, mg)
    prod_f = add(one, mul(cra, sub(db, one)))
    return ins_f, del_f, req, resp, da, db, lgnum, prod_f

def _aux_scans(ins_f, del_f, req, resp, da, db, lgnum, prod_f):
    """Inversions and running products / sums of the bus factors."""
    n = ins_f.shape[-1]
    invs = batch_inv(torch.stack([del_f, resp, da, db]), axis=-1)
    i_del, i_resp, i_da, i_db = invs[0], invs[1], invs[2], invs[3]
    one = torch.ones(1, dtype=torch.int64, device=ins_f.device)

    def scan_prod(f):
        # aux[k] = prod_{i<k} f[i]: the wrap factor at n-1 never enters
        return torch.cat([one, gf_cumprod(f[:n - 1])])

    aux0 = scan_prod(mul(ins_f, i_del))
    aux1 = scan_prod(mul(req, i_resp))
    d2 = sub(i_da, mul(lgnum, i_db))
    aux2 = torch.cat([torch.zeros_like(one), gf_cumsum(d2[:n - 1])])
    aux3 = scan_prod(prod_f)
    zeros = torch.zeros((5, n), dtype=torch.int64, device=ins_f.device)
    return torch.cat([torch.stack([aux0, aux1, aux2, aux3]), zeros])


def make_public_inputs(program_hash: List[int],
                       stack_inputs_topfirst: List[int],
                       output_stack: List[int],
                       overflow=None) -> PublicInputs:
    """Build golden-encoding public inputs: stack_inputs stored
    bottom-first, outputs as the full 16-slot final stack (top-first).
    `overflow` is the final overflow table as (addr, value) pairs
    bottom-first (the third element of vm.execute_full) — its values are
    appended to output_stack newest-first and its addresses fill
    overflow_addrs, matching the golden encoding's non-empty overflow
    fields (miden-proof-generator/src/main.rs:35-38)."""
    outs = (list(output_stack) + [0] * 16)[:16]
    rows = list(overflow or [])
    outs += [int(v) for a, v in reversed(rows)]   # newest-first
    return PublicInputs(
        program_hash=list(program_hash),
        stack_inputs=list(reversed(stack_inputs_topfirst)),
        output_stack=outs,
        overflow_addrs=[int(a) for a, v in reversed(rows)],
    )
