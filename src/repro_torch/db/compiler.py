"""Query compiler: predicate/aggregate ASTs -> PIM instruction programs.

The stand-in for the paper's in-house SQL compiler (§5.4): it receives the
encoded relation layout and an expression tree, and emits the bit-serial
instruction sequence a PIM controller executes. Immediates stay immediates
(Algorithm 1), attribute widths come from the layout, derived values get
fresh computation-area registers, and every filter program ends with the
column-transform that re-orients the result bits for dense readout.

Predicates are *canonicalized* before compilation (:func:`canonicalize`):
commutative ``And``/``Or`` children are flattened, deduplicated and
sorted by structural key, ``Cmp`` direction is normalized (``gt``/``ge``
become swapped ``lt``/``le``), ``Between`` folds into its ``And(ge, le)``
form, and ``InSet`` value lists are sorted sets. Structurally-equal
subtrees therefore share one :func:`struct_key` (and one
:func:`canonical_hash`) — the compiler reuses the mask register of any
subtree it already compiled, and ``core.program.link_programs`` relies on
the same canonical forms to dedup subexpressions *across* queries.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import engine as eng
from repro_torch.core import isa


# --------------------------------------------------------------------------
# Expression AST
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Col:
    name: str


@dataclasses.dataclass(frozen=True)
class Lit:
    value: int


@dataclasses.dataclass(frozen=True)
class Cmp:
    op: str                     # eq ne lt le gt ge
    left: "Expr"
    right: Union["Expr", Lit]


@dataclasses.dataclass(frozen=True)
class Between:
    col: "Expr"
    lo: int
    hi: int                     # inclusive


@dataclasses.dataclass(frozen=True)
class InSet:
    col: "Expr"
    values: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Not:
    p: "Pred"


@dataclasses.dataclass(frozen=True)
class And:
    ps: Tuple["Pred", ...]

    def __init__(self, *ps):
        object.__setattr__(self, "ps", tuple(ps))


@dataclasses.dataclass(frozen=True)
class Or:
    ps: Tuple["Pred", ...]

    def __init__(self, *ps):
        object.__setattr__(self, "ps", tuple(ps))


@dataclasses.dataclass(frozen=True)
class Mul:
    a: "Expr"
    b: Union["Expr", Lit]


@dataclasses.dataclass(frozen=True)
class AddE:
    a: "Expr"
    b: Union["Expr", Lit]


@dataclasses.dataclass(frozen=True)
class RSubImm:
    """imm - expr (e.g. (1 - discount) scaled -> 100 - l_discount)."""
    imm: int
    e: "Expr"


Expr = Union[Col, Mul, AddE, RSubImm]
Pred = Union[Cmp, Between, InSet, Not, And, Or]


@dataclasses.dataclass(frozen=True)
class Agg:
    op: str                     # sum count min max avg
    expr: Optional[Expr] = None
    name: str = ""


# --------------------------------------------------------------------------
# Structural canonical form
# --------------------------------------------------------------------------
# Direction-normalizing swaps: gt/ge become lt/le with operands exchanged
# (the imm path already compiles both directions to the same comparator;
# canonicalizing the AST makes the *keys* equal too).
_CMP_SWAP = {"gt": "lt", "ge": "le"}


def _skey(node) -> tuple:
    """Nested-tuple structural identity of an AST node (order-preserving
    for non-commutative operators — Mul/AddE operand order is cost-model
    relevant, the Multiply cycle formula is asymmetric in (n, m))."""
    if isinstance(node, Col):
        return ("Col", node.name)
    if isinstance(node, Lit):
        return ("Lit", int(node.value))
    if isinstance(node, Cmp):
        return ("Cmp", node.op, _skey(node.left), _skey(node.right))
    if isinstance(node, Between):
        return ("Between", _skey(node.col), int(node.lo), int(node.hi))
    if isinstance(node, InSet):
        return ("InSet", _skey(node.col), tuple(sorted(node.values)))
    if isinstance(node, Not):
        return ("Not", _skey(node.p))
    if isinstance(node, (And, Or)):
        return (type(node).__name__,) + tuple(_skey(q) for q in node.ps)
    if isinstance(node, (Mul, AddE)):
        return (type(node).__name__, _skey(node.a), _skey(node.b))
    if isinstance(node, RSubImm):
        return ("RSubImm", int(node.imm), _skey(node.e))
    raise TypeError(node)


def struct_key(node) -> str:
    """Stable, totally-ordered structural key of a predicate/expression.

    A string (not Python ``hash()``, which is per-process randomized for
    strings) so it can both sort commutative children deterministically
    and identify structurally-equal subtrees across independently
    compiled queries.
    """
    return repr(_skey(node))


def canonical_hash(node) -> str:
    """Short stable digest of :func:`struct_key` (for labels/signatures)."""
    return hashlib.sha256(struct_key(node).encode()).hexdigest()[:16]


def canonicalize(p: "Pred") -> "Pred":
    """Rewrite a predicate into its structural canonical form.

    Equal-meaning trees become equal-keyed trees: ``And``/``Or`` nests
    flatten, children dedup and sort by :func:`struct_key`; ``gt``/``ge``
    comparisons between expressions become swapped ``lt``/``le``;
    ``eq``/``ne`` operand pairs sort; ``Between`` folds to ``And(ge, le)``
    (it compiles to the identical instruction triple); ``InSet`` values
    become a sorted set; double negation cancels. Expression operand
    order is deliberately preserved (see :func:`_skey`), so the
    instruction *multiset* — and with it every Table-4 cycle count — is
    unchanged by canonicalization; only emission order moves.
    """
    if isinstance(p, Cmp):
        left = p.left
        right = p.right
        op = p.op
        if not isinstance(right, Lit):
            if op in _CMP_SWAP:
                op = _CMP_SWAP[op]
                left, right = right, left
            elif op in ("eq", "ne") and struct_key(right) < struct_key(left):
                left, right = right, left
        return Cmp(op, left, right) if (op, left, right) != \
            (p.op, p.left, p.right) else p
    if isinstance(p, Between):
        return And(Cmp("ge", p.col, Lit(p.lo)),
                   Cmp("le", p.col, Lit(p.hi)))
    if isinstance(p, InSet):
        vals = tuple(sorted(set(p.values)))
        return p if vals == p.values else InSet(p.col, vals)
    if isinstance(p, Not):
        q = canonicalize(p.p)
        if isinstance(q, Not):
            return q.p
        return p if q is p.p else Not(q)
    if isinstance(p, (And, Or)):
        cls = type(p)
        flat: List[Pred] = []
        for q in p.ps:
            cq = canonicalize(q)
            flat.extend(cq.ps if isinstance(cq, cls) else (cq,))
        seen: Dict[str, Pred] = {}
        for q in flat:
            seen.setdefault(struct_key(q), q)
        kids = [seen[k] for k in sorted(seen)]
        if len(kids) == 1:
            return kids[0]
        return cls(*kids)
    return p


# --------------------------------------------------------------------------
# Compiler
# --------------------------------------------------------------------------
class Compiler:
    """``namespace`` prefixes every register this compiler allocates
    (``q0.t0``, ``q0.m1``, …): two programs compiled over the same
    relation no longer collide on ``t0``/``m0`` when concatenated or
    linked (``core.program.link_programs`` additionally uniquifies as a
    backstop)."""

    def __init__(self, relation: eng.PimRelation, namespace: str = ""):
        self.rel = relation
        self.namespace = namespace
        self._ids = itertools.count()
        self.program: List[isa.PimInstruction] = []
        self._expr_cache: Dict[Expr, Tuple[str, int]] = {}
        self._pred_cache: Dict[str, str] = {}

    def fresh(self, prefix: str) -> str:
        return f"{self.namespace}{prefix}{next(self._ids)}"

    # -- expressions --------------------------------------------------------
    def compile_expr(self, e: Expr) -> Tuple[str, int]:
        """Returns (register/attr name, width in bits)."""
        if isinstance(e, Col):
            return e.name, self.rel.width_of(e.name)
        if e in self._expr_cache:
            return self._expr_cache[e]
        if isinstance(e, Mul):
            a, wa = self.compile_expr(e.a)
            if isinstance(e.b, Lit):
                wb = max(1, int(e.b.value).bit_length())
                dest = self.fresh("t")
                self.program.append(isa.Multiply(
                    dest=dest, attr_a=a, imm=e.b.value,
                    n_bits=wa + wb, m_bits=wb))
            else:
                b, wb = self.compile_expr(e.b)
                dest = self.fresh("t")
                self.program.append(isa.Multiply(
                    dest=dest, attr_a=a, attr_b=b, n_bits=wa + wb, m_bits=wb))
            out = (dest, wa + wb)
        elif isinstance(e, AddE):
            a, wa = self.compile_expr(e.a)
            if isinstance(e.b, Lit):
                wb = max(1, int(e.b.value).bit_length())
                dest = self.fresh("t")
                self.program.append(isa.AddImm(
                    dest=dest, attr=a, imm=e.b.value, n_bits=max(wa, wb) + 1))
            else:
                b, wb = self.compile_expr(e.b)
                dest = self.fresh("t")
                self.program.append(isa.Add(
                    dest=dest, attr_a=a, attr_b=b, n_bits=max(wa, wb) + 1))
            out = (dest, max(wa, wb) + 1)
        elif isinstance(e, RSubImm):
            # imm - a  ==  (~a + imm + 1) mod 2^w, exact while a <= imm.
            a, wa = self.compile_expr(e.e)
            w = max(wa, int(e.imm).bit_length())
            neg = self.fresh("t")
            self.program.append(isa.BitwiseNot(dest=neg, src=a, n_bits=w))
            dest = self.fresh("t")
            self.program.append(isa.AddImm(
                dest=dest, attr=neg, imm=e.imm + 1, n_bits=w))
            out = (dest, w)
        else:
            raise TypeError(e)
        self._expr_cache[e] = out
        return out

    # -- predicates ----------------------------------------------------------
    def compile_pred(self, p: Pred) -> str:
        """Returns the mask register holding the predicate result.

        The predicate is canonicalized first, and every compiled subtree
        is cached under its structural key — a structurally-equal subtree
        appearing again anywhere in this compiler's program (another
        conjunct, a group predicate, a later ``compile_filter``) reuses
        the existing mask register instead of recomputing it.
        """
        p = canonicalize(p)
        key = struct_key(p)
        cached = self._pred_cache.get(key)
        if cached is not None:
            return cached
        reg = self._compile_pred_node(p)
        self._pred_cache[key] = reg
        return reg

    def _compile_pred_node(self, p: Pred) -> str:
        if isinstance(p, Cmp):
            return self._compile_cmp(p)
        if isinstance(p, InSet):
            if not p.values:
                # Empty IN-list: constant-false mask (previously returned
                # None and crashed the enclosing BitwiseAnd).
                m = self.fresh("m")
                self.program.append(isa.SetReset(dest=m, value=0))
                return m
            a, w = self.compile_expr(p.col)
            acc = None
            for v in p.values:
                m = self.fresh("m")
                self.program.append(isa.EqualImm(dest=m, attr=a, imm=v, n_bits=w))
                if acc is None:
                    acc = m
                else:
                    nxt = self.fresh("m")
                    self.program.append(isa.BitwiseOr(dest=nxt, src_a=acc, src_b=m))
                    acc = nxt
            return acc
        if isinstance(p, Not):
            m = self.compile_pred(p.p)
            out = self.fresh("m")
            self.program.append(isa.BitwiseNot(dest=out, src=m, n_bits=1))
            return out
        if isinstance(p, And):
            return self._fold(p.ps, isa.BitwiseAnd)
        if isinstance(p, Or):
            return self._fold(p.ps, isa.BitwiseOr)
        raise TypeError(p)

    def _fold(self, ps, op_cls) -> str:
        acc = self.compile_pred(ps[0])
        for q in ps[1:]:
            m = self.compile_pred(q)
            nxt = self.fresh("m")
            self.program.append(op_cls(dest=nxt, src_a=acc, src_b=m))
            acc = nxt
        return acc

    def _compile_cmp(self, p: Cmp) -> str:
        a, wa = self.compile_expr(p.left)
        dest = self.fresh("m")
        if isinstance(p.right, Lit):
            v = int(p.right.value)
            if v >= (1 << wa) and p.op in ("eq", "ne"):
                # Immediate unrepresentable in the attribute width: the
                # comparison is constant (guards dict-id typos too).
                self.program.append(isa.SetReset(
                    dest=dest, value=int(p.op == "ne")))
                return dest
            if p.op == "eq":
                self.program.append(isa.EqualImm(dest=dest, attr=a, imm=v, n_bits=wa))
            elif p.op == "ne":
                self.program.append(isa.NotEqualImm(dest=dest, attr=a, imm=v, n_bits=wa))
            elif p.op in ("lt", "le"):
                self.program.append(isa.LessThanImm(
                    dest=dest, attr=a, imm=v, n_bits=wa, or_equal=p.op == "le"))
            elif p.op in ("gt", "ge"):
                self.program.append(isa.GreaterThanImm(
                    dest=dest, attr=a, imm=v, n_bits=wa, or_equal=p.op == "ge"))
            else:
                raise ValueError(p.op)
        else:
            b, wb = self.compile_expr(p.right)
            w = max(wa, wb)
            if p.op == "eq":
                self.program.append(isa.Equal(dest=dest, attr_a=a, attr_b=b, n_bits=w))
            elif p.op == "ne":
                tmp = self.fresh("m")
                self.program.append(isa.Equal(dest=tmp, attr_a=a, attr_b=b, n_bits=w))
                self.program.append(isa.BitwiseNot(dest=dest, src=tmp, n_bits=1))
            elif p.op in ("lt", "le"):
                self.program.append(isa.LessThan(
                    dest=dest, attr_a=a, attr_b=b, n_bits=w, or_equal=p.op == "le"))
            elif p.op in ("gt", "ge"):
                self.program.append(isa.LessThan(
                    dest=dest, attr_a=b, attr_b=a, n_bits=w, or_equal=p.op == "ge"))
            else:
                raise ValueError(p.op)
        return dest

    # -- top level -----------------------------------------------------------
    def compile_filter(self, pred: Pred, with_transform: bool = True) -> str:
        """Filter program: predicate AND valid, then column-transform so the
        host can read the result densely (paper filter-only path)."""
        m = self.compile_pred(pred)
        out = self.fresh("m")
        self.program.append(isa.BitwiseAnd(dest=out, src_a=m, src_b="__valid__"))
        if with_transform:
            final = self.fresh("m")
            self.program.append(isa.ColumnTransform(dest=final, mask=out))
            return final
        return out

    def compile_scan_all(self) -> str:
        """Constant-true selection (ANDed with the valid plane): the mask
        a relation with no PIM predicate materializes under — every live
        record, no padding rows."""
        m = self.fresh("m")
        self.program.append(isa.SetReset(dest=m, value=1))
        out = self.fresh("m")
        self.program.append(isa.BitwiseAnd(dest=out, src_a=m,
                                           src_b="__valid__"))
        return out

    def compile_materialize(self, mask: str, attrs: Sequence[str]) -> str:
        """Read the mask-selected records of ``attrs`` back as integers
        (the PIM->host hand-off of the end-to-end query path)."""
        dest = self.fresh("v")
        n_bits = sum(self.rel.width_of(a) for a in attrs)
        self.program.append(isa.Materialize(
            dest=dest, attrs=tuple(attrs), mask=mask, n_bits=n_bits))
        return dest

    def compile_aggregates(self, mask: str, aggs: Sequence[Agg]) -> Dict[str, Tuple[str, str]]:
        """Aggregate program on a filter mask (paper full-query path).

        Returns {agg name: (kind, register)} where kind is 'scalar',
        'minmax' (may be empty -> None) or 'avg_pair' (avg = host division
        of sum/count, §4.2).
        """
        out: Dict[str, Tuple[str, str]] = {}
        for agg in aggs:
            name = agg.name or self.fresh("agg")
            if agg.op == "count":
                dest = self.fresh("r")
                self.program.append(isa.ReduceSum(
                    dest=dest, attr=mask, mask=mask, n_bits=1))
                out[name] = ("scalar", dest)
            elif agg.op in ("sum", "avg"):
                a, w = self.compile_expr(agg.expr)
                dest = self.fresh("r")
                self.program.append(isa.ReduceSum(
                    dest=dest, attr=a, mask=mask, n_bits=w))
                if agg.op == "avg":
                    cnt = self.fresh("r")
                    self.program.append(isa.ReduceSum(
                        dest=cnt, attr=mask, mask=mask, n_bits=1))
                    out[name] = ("avg_pair", f"{dest}/{cnt}")
                else:
                    out[name] = ("scalar", dest)
            elif agg.op in ("min", "max"):
                a, w = self.compile_expr(agg.expr)
                dest = self.fresh("r")
                self.program.append(isa.ReduceMinMax(
                    dest=dest, attr=a, mask=mask, n_bits=w,
                    is_max=agg.op == "max"))
                out[name] = ("minmax", dest)
            else:
                raise ValueError(agg.op)
        return out


def predicate_attrs(p: Pred) -> List[str]:
    """Attributes a predicate touches (for the baseline traffic model)."""
    cols: List[str] = []

    def walk_e(e):
        if isinstance(e, Col):
            cols.append(e.name)
        elif isinstance(e, (Mul, AddE)):
            walk_e(e.a)
            if not isinstance(e.b, Lit):
                walk_e(e.b)
        elif isinstance(e, RSubImm):
            walk_e(e.e)

    def walk_p(q):
        if isinstance(q, Cmp):
            walk_e(q.left)
            if not isinstance(q.right, Lit):
                walk_e(q.right)
        elif isinstance(q, (Between, InSet)):
            walk_e(q.col)
        elif isinstance(q, Not):
            walk_p(q.p)
        elif isinstance(q, (And, Or)):
            for s in q.ps:
                walk_p(s)

    walk_p(p)
    seen, out = set(), []
    for c in cols:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return out
