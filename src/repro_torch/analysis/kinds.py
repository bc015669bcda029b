"""Kind/width checker (pass ``kinds``), the counterpart of
``repro.analysis.kinds``.

Independently re-derives every register's kind (mask / derived / scalar
/ values) and plane width through the same transition rules the
evaluators execute, then cross-checks the result against
``analyze_program``'s ``reg_kind``/``widths`` — a disagreement means the
liveness analysis would free or size a register differently from how the
backend actually uses it, which is an error.

Operand checks (errors): mask logic (``BitwiseAnd``/``BitwiseOr``) on a
derived or source operand would index the evaluator's mask file and
KeyError at trace time; reduce/transform/materialize masks must be mask
registers; scalar/values registers are host-side and can never be read
as plane operands; on the fused backend ``Materialize`` attrs must be
relation source attributes (the materialize kernel streams
``planes[attr]`` directly, as the reference's Pallas kernel does; the
message keeps the reference's wording, so the two verifiers' diagnostics
compare equal).

Width checks (warnings — semantically defined mod-2^n, but almost
always unintended): ``Add``/``AddImm`` results needing ``max(wa,wb)+1``
bits stored into fewer, ``Multiply`` results needing ``wa+wb``,
``BitwiseNot`` dropping operand planes, immediates wider than
``n_bits``, and Table-4 cost drift (``n_bits`` or ``m_bits`` not
matching the operand widths the cycles formula assumes). The
two's-complement subtract idiom (``BitwiseNot`` then ``AddImm`` at the
same width — the compiler's ``RSubImm`` lowering) is recognized and not
flagged: its mod-2^w wraparound is the point.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .diagnostics import Diagnostic
from .passes import PassContext, register_pass

_DERIVED_KINDS = ("AddImm", "Add", "Subtract", "Multiply")
_IMM_CMP_KINDS = ("EqualImm", "NotEqualImm", "LessThanImm", "GreaterThanImm")


def _d(sev: str, msg: str, i=None, kind=None, reg=None) -> Diagnostic:
    return Diagnostic("kinds", sev, msg, instr_index=i, instr_kind=kind,
                      register=reg)


def _bitlen(v: int) -> int:
    return max(1, int(v).bit_length())


@register_pass("kinds")
def run(ctx: PassContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    instrs = ctx.instrs
    kind_of: Dict[str, str] = {"__valid__": "mask"}
    width_of: Dict[str, int] = {"__valid__": 1}
    complements: set = set()       # dests of attribute-NOT (subtract idiom)
    ssa = len({ins.dest for ins in instrs}) == len(instrs)

    def operand(r: str) -> Tuple[Optional[str], int]:
        if r in kind_of:
            return kind_of[r], width_of[r]
        if ctx.is_source(r):
            return "source", ctx.source_widths[r]
        return None, 0             # undefined: defuse reports it

    def plane_operand(r: str, i: int, k: str) -> Tuple[Optional[str], int]:
        """An operand read as a plane stack: anything but scalar/values."""
        kr, wr = operand(r)
        if kr in ("scalar", "values"):
            diags.append(_d("error",
                            f"operand '{r}' is a {kr} register (host-side "
                            "readout, not planes)", i, k, r))
            return None, 0
        return kr, wr

    for i, ins in enumerate(instrs):
        k = ins.kind
        dest_kind, dest_width = "mask", 1

        if k in _IMM_CMP_KINDS:
            kr, wr = plane_operand(ins.attr, i, k)
            if kr in ("derived", "source"):
                if ins.n_bits != wr:
                    diags.append(_d("warning",
                                    f"n_bits={ins.n_bits} but operand "
                                    f"'{ins.attr}' has {wr} planes: Table 4 "
                                    "cycles drift from executed semantics",
                                    i, k, ins.attr))
                if ins.imm >= (1 << wr):
                    diags.append(_d("warning",
                                    f"immediate {ins.imm} unrepresentable "
                                    f"in {wr} bits: comparison is constant "
                                    "(short-circuited at trace time, cycles "
                                    "still charged)", i, k, ins.attr))
        elif k in ("Equal", "LessThan"):
            _, wa = plane_operand(ins.attr_a, i, k)
            _, wb = plane_operand(ins.attr_b, i, k)
            if ins.n_bits != max(wa, wb):
                diags.append(_d("warning",
                                f"n_bits={ins.n_bits} but operands span "
                                f"{max(wa, wb)} planes: Table 4 cycles "
                                "drift", i, k, ins.dest))
        elif k in ("BitwiseAnd", "BitwiseOr"):
            for r in (ins.src_a, ins.src_b):
                kr, wr = operand(r)
                if kr in ("derived", "source"):
                    diags.append(_d("error",
                                    f"mask-logic operand '{r}' is {kr} "
                                    f"({wr} planes): the evaluator indexes "
                                    "the mask file directly and would fail "
                                    "at trace time", i, k, r))
                elif kr in ("scalar", "values"):
                    diags.append(_d("error",
                                    f"mask-logic operand '{r}' is a {kr} "
                                    "register", i, k, r))
            if ins.n_bits != 1:
                diags.append(_d("warning",
                                f"mask {k} with n_bits={ins.n_bits} "
                                "overcharges cycles (masks are 1 plane)",
                                i, k, ins.dest))
        elif k == "BitwiseNot":
            kr, wr = operand(ins.src)
            if kr in ("scalar", "values"):
                diags.append(_d("error",
                                f"NOT operand '{ins.src}' is a {kr} "
                                "register", i, k, ins.src))
            if kr == "mask":
                if ins.n_bits != 1:
                    diags.append(_d("warning",
                                    f"mask NOT with n_bits={ins.n_bits} "
                                    "overcharges cycles", i, k, ins.dest))
            else:
                # Attribute NOT: multi-plane complement (RSubImm lowering).
                dest_kind, dest_width = "derived", ins.n_bits
                complements.add(ins.dest)
                if kr in ("derived", "source") and ins.n_bits < wr:
                    diags.append(_d("warning",
                                    f"NOT truncates '{ins.src}' from {wr} "
                                    f"to {ins.n_bits} planes", i, k,
                                    ins.src))
        elif k == "SetReset":
            pass
        elif k in _DERIVED_KINDS:
            dest_kind, dest_width = "derived", ins.n_bits
            if k == "AddImm":
                kr, wa = plane_operand(ins.attr, i, k)
                imm_w = _bitlen(ins.imm)
                if ins.attr in complements:
                    pass    # two's-complement subtract: mod-2^w is exact
                else:
                    if ins.n_bits < max(wa, imm_w) + 1:
                        diags.append(_d("warning",
                                        "possible overflow: a + imm needs "
                                        f"up to {max(wa, imm_w) + 1} bits, "
                                        f"n_bits={ins.n_bits} (result is "
                                        f"mod 2^{ins.n_bits})", i, k,
                                        ins.dest))
                    if imm_w > ins.n_bits:
                        diags.append(_d("warning",
                                        f"immediate {ins.imm} is wider than "
                                        f"n_bits={ins.n_bits}: high bits "
                                        "are silently dropped", i, k,
                                        ins.dest))
            elif k == "Add":
                _, wa = plane_operand(ins.attr_a, i, k)
                _, wb = plane_operand(ins.attr_b, i, k)
                if ins.n_bits < max(wa, wb) + 1:
                    diags.append(_d("warning",
                                    "possible overflow: a + b needs up to "
                                    f"{max(wa, wb) + 1} bits, n_bits="
                                    f"{ins.n_bits}", i, k, ins.dest))
            elif k == "Subtract":
                _, wa = plane_operand(ins.attr_a, i, k)
                _, wb = plane_operand(ins.attr_b, i, k)
                if ins.n_bits < max(wa, wb):
                    diags.append(_d("warning",
                                    f"a - b truncated to {ins.n_bits} bits "
                                    f"(operands span {max(wa, wb)})",
                                    i, k, ins.dest))
            elif k == "Multiply":
                _, wa = plane_operand(ins.attr_a, i, k)
                if ins.imm is not None:
                    wb = _bitlen(ins.imm)
                else:
                    _, wb = plane_operand(ins.attr_b, i, k)
                if ins.n_bits < wa + wb:
                    diags.append(_d("warning",
                                    f"possible overflow: a * b needs up to "
                                    f"{wa + wb} bits, n_bits={ins.n_bits}",
                                    i, k, ins.dest))
                if ins.m_bits != wb:
                    diags.append(_d("warning",
                                    f"m_bits={ins.m_bits} but the second "
                                    f"operand is {wb} bits: Table 4 "
                                    "Multiply cycles drift", i, k,
                                    ins.dest))
        elif k in ("ReduceSum", "ReduceMinMax"):
            dest_kind, dest_width = "scalar", 0
            ka, wa = plane_operand(ins.attr, i, k)
            km, _ = operand(ins.mask)
            if km is not None and km != "mask":
                diags.append(_d("error",
                                f"reduce mask operand '{ins.mask}' is "
                                f"{km}, not a mask register", i, k,
                                ins.mask))
            expected = 1 if ka == "mask" else wa
            if ka is not None and ins.n_bits != expected:
                diags.append(_d("warning",
                                f"n_bits={ins.n_bits} but the reduced "
                                f"operand '{ins.attr}' spans {expected} "
                                "plane(s): readout weighting and cycles "
                                "drift", i, k, ins.attr))
        elif k == "Materialize":
            dest_kind, dest_width = "values", 0
            total_w = 0
            for a in ins.attrs:
                ka, wa = operand(a)
                total_w += wa
                if ka != "source":
                    sev = "error" if ctx.backend == "fused" else "warning"
                    diags.append(_d(sev,
                                    f"materialize attr '{a}' is {ka}, not "
                                    "a relation source attribute (the "
                                    "pallas readout kernel streams source "
                                    "planes only)", i, k, a))
            km, _ = operand(ins.mask)
            if km is not None and km != "mask":
                diags.append(_d("error",
                                f"materialize mask '{ins.mask}' is {km}, "
                                "not a mask register", i, k, ins.mask))
            if total_w and ins.n_bits != total_w:
                diags.append(_d("warning",
                                f"n_bits={ins.n_bits} but the materialized "
                                f"attrs span {total_w} planes: readout "
                                "traffic accounting drifts", i, k,
                                ins.dest))
        elif k == "ColumnTransform":
            km, _ = operand(ins.mask)
            if km is not None and km != "mask":
                diags.append(_d("error",
                                f"column-transform mask '{ins.mask}' is "
                                f"{km}, not a mask register", i, k,
                                ins.mask))
        elif k in ("PlaneWrite", "ValidClear"):
            # DML write kinds target relation STORAGE, not a register:
            # dest must be a source attribute (PlaneWrite) or the valid
            # plane; no kind/width registration happens.
            if k == "ValidClear" or ins.dest == "__valid__":
                if ins.dest != "__valid__":
                    diags.append(_d("error",
                                    f"ValidClear dest '{ins.dest}' must be "
                                    "'__valid__'", i, k, ins.dest))
            elif not ctx.is_source(ins.dest):
                diags.append(_d("error",
                                f"PlaneWrite dest '{ins.dest}' is not a "
                                "relation attribute (writes program "
                                "storage, not registers)", i, k, ins.dest))
            elif ins.n_bits != ctx.source_widths[ins.dest]:
                diags.append(_d("warning",
                                f"n_bits={ins.n_bits} but attribute "
                                f"'{ins.dest}' spans "
                                f"{ctx.source_widths[ins.dest]} planes: "
                                "write cost and endurance accounting "
                                "drift", i, k, ins.dest))
            if k == "PlaneWrite" and len(ins.rows) != len(ins.values):
                diags.append(_d("error",
                                f"PlaneWrite rows ({len(ins.rows)}) and "
                                f"values ({len(ins.values)}) disagree",
                                i, k, ins.dest))
            continue
        else:
            diags.append(_d("error", f"unknown instruction kind {k!r}",
                            i, k, ins.dest))
            continue

        kind_of[ins.dest] = dest_kind
        width_of[ins.dest] = dest_width

        # -- cross-check against the compile pipeline's analysis ----------
        if ctx.analysis is not None and ssa:
            a_kind = ctx.analysis.reg_kind.get(ins.dest)
            a_width = ctx.analysis.widths.get(ins.dest)
            if a_kind != dest_kind:
                diags.append(_d("error",
                                f"kind inference disagrees on '{ins.dest}': "
                                f"analyze_program says {a_kind!r}, the "
                                f"transition rules say {dest_kind!r} — "
                                "liveness would free/size it wrongly",
                                i, k, ins.dest))
            elif a_width != dest_width:
                diags.append(_d("error",
                                f"width inference disagrees on "
                                f"'{ins.dest}': analyze_program says "
                                f"{a_width}, the transition rules say "
                                f"{dest_width}", i, k, ins.dest))
    return diags
