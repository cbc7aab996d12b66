"""JSON-schema → token-FSM compiler for grammar-constrained decoding.

Following Willard & Louf 2023 ("Efficient Guided Generation for Large
Language Models" / Outlines): a schema is lowered to a regular grammar,
compiled through Thompson NFA → subset-construction DFA over *characters*,
then lifted to a dense token-transition table the on-device sampler indexes
per decode step.  With ``ByteTokenizer`` (ids 0=pad 1=bos 2=eos, bytes at
3..258) the char→token lift is exact and 1:1; multi-byte BPE vocabs would
walk each token's byte string through the char DFA the same way (the table
stays ``[states, vocab]`` — at 128k vocab that is the packed-mask future
work noted in docs/diagnosis.md).

The supported schema subset (deliberately the shape structured verdicts
need, all of it producing a *bounded* regular language so ``max_len`` is
finite and the engine can guarantee completion before ``max_tokens``):

  * ``object`` with ordered ``properties`` (all required, emitted in
    declaration order, compact separators — one canonical serialization);
  * ``string`` with ``maxLength`` (and optional ``minLength``) over a
    JSON-safe charset (printable ASCII minus ``"`` and ``\\``);
  * ``enum`` of strings;
  * ``number`` (bounded decimal), ``integer``, ``boolean``;
  * ``array`` of a supported item schema with ``maxItems``.

``parse_verdict`` is the single sanctioned place model output becomes
parsed JSON: it validates against the char DFA first, so ``json.loads``
can never see anything the grammar didn't admit (the graftcheck
``model-json`` lint rule flags raw ``json.loads`` of model output
everywhere else).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

# ByteTokenizer special ids (utils/tokenizer.py) — the default lift target.
_PAD_ID, _BOS_ID, _EOS_ID = 0, 1, 2
_BYTE_OFFSET = 3
_BYTE_VOCAB = 259

# JSON-safe string payload charset: printable ASCII minus '"' and '\', so
# the canonical serialization needs no escape productions.
_STRING_CHARS = frozenset(
    chr(c) for c in range(0x20, 0x7F) if chr(c) not in ('"', "\\")
)
_DIGITS = frozenset("0123456789")
_DIGITS19 = frozenset("123456789")


class GrammarError(ValueError):
    """Schema unsupported, or text rejected by the compiled grammar."""


# ---------------------------------------------------------------------------
# regular-expression AST (bounded constructs only)
# ---------------------------------------------------------------------------


class _Node:
    pass


@dataclass(frozen=True)
class _Lit(_Node):
    text: str


@dataclass(frozen=True)
class _Class(_Node):
    chars: frozenset


@dataclass(frozen=True)
class _Seq(_Node):
    parts: tuple


@dataclass(frozen=True)
class _Alt(_Node):
    parts: tuple


@dataclass(frozen=True)
class _Empty(_Node):
    pass


def _seq(*parts: _Node) -> _Node:
    return _Seq(tuple(parts))


def _alt(*parts: _Node) -> _Node:
    return _Alt(tuple(parts))


def _rep(part: _Node, lo: int, hi: int) -> _Node:
    """``part{lo,hi}`` with bounded ``hi``, expanded as nested optionals
    (``p{0,3} = (p(p(p)?)?)?``) so a skipped copy can't be followed by a
    taken one."""
    if hi < lo or lo < 0:
        raise GrammarError(f"bad repetition bounds {{{lo},{hi}}}")
    opt: _Node = _Empty()
    for _ in range(hi - lo):
        opt = _alt(_seq(part, opt), _Empty())
    return _seq(*([part] * lo), opt)


# ---------------------------------------------------------------------------
# Thompson NFA → subset-construction char DFA
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self) -> None:
        self.eps: list[set[int]] = []
        self.edges: list[dict[str, set[int]]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.edges.append({})
        return len(self.eps) - 1

    def add(self, src: int, ch: str, dst: int) -> None:
        self.edges[src].setdefault(ch, set()).add(dst)

    def build(self, node: _Node, src: int) -> int:
        """Wire ``node`` starting at ``src``; returns its exit state."""
        if isinstance(node, _Empty):
            return src
        if isinstance(node, _Lit):
            cur = src
            for ch in node.text:
                nxt = self.state()
                self.add(cur, ch, nxt)
                cur = nxt
            return cur
        if isinstance(node, _Class):
            if not node.chars:
                raise GrammarError("empty character class")
            dst = self.state()
            for ch in node.chars:
                self.add(src, ch, dst)
            return dst
        if isinstance(node, _Seq):
            cur = src
            for part in node.parts:
                cur = self.build(part, cur)
            return cur
        if isinstance(node, _Alt):
            out = self.state()
            for part in node.parts:
                entry = self.state()
                self.eps[src].add(entry)
                self.eps[self.build(part, entry)].add(out)
            return out
        raise GrammarError(f"unknown AST node {type(node).__name__}")

    def closure(self, states: Iterable[int]) -> frozenset:
        stack = list(states)
        seen = set(stack)
        while stack:
            for nxt in self.eps[stack.pop()]:
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return frozenset(seen)


@dataclass
class CharDFA:
    """Deterministic char automaton; state 0 is the start state."""

    trans: list[dict[str, int]]
    accept: list[bool]

    def matches(self, text: str) -> bool:
        state = 0
        for ch in text:
            nxt = self.trans[state].get(ch)
            if nxt is None:
                return False
            state = nxt
        return self.accept[state]

    def max_path_len(self) -> int:
        """Longest char count of any accepted string; -1 if unbounded."""
        n = len(self.trans)
        memo: list[int | None] = [None] * n
        on_stack = [False] * n
        UNBOUNDED = -1

        def longest(s: int) -> int:
            if on_stack[s]:
                return UNBOUNDED
            if memo[s] is not None:
                return memo[s]
            on_stack[s] = True
            best = 0 if self.accept[s] else -(10**9)
            for nxt in self.trans[s].values():
                sub = longest(nxt)
                if sub == UNBOUNDED:
                    on_stack[s] = False
                    memo[s] = UNBOUNDED
                    return UNBOUNDED
                best = max(best, 1 + sub)
            on_stack[s] = False
            memo[s] = best
            return best

        total = longest(0)
        return UNBOUNDED if total == UNBOUNDED else max(total, 0)


def _determinize(nfa: _NFA, start: int, final: int) -> CharDFA:
    start_set = nfa.closure([start])
    index: dict[frozenset, int] = {start_set: 0}
    order: list[frozenset] = [start_set]
    trans: list[dict[str, int]] = [{}]
    i = 0
    while i < len(order):
        cur = order[i]
        moves: dict[str, set[int]] = {}
        for s in cur:
            for ch, dsts in nfa.edges[s].items():
                moves.setdefault(ch, set()).update(dsts)
        for ch, dsts in moves.items():
            tgt = nfa.closure(dsts)
            if tgt not in index:
                index[tgt] = len(order)
                order.append(tgt)
                trans.append({})
            trans[i][ch] = index[tgt]
        i += 1
    accept = [final in subset for subset in order]
    dfa = CharDFA(trans=trans, accept=accept)
    _prune_dead_ends(dfa)
    return dfa


def _prune_dead_ends(dfa: CharDFA) -> None:
    """Drop transitions into states that cannot reach accept — a sampler
    steered into such a state would have no allowed token and no way to
    finish.  A correct construction produces none; this is the compile-time
    guarantee, not a runtime patch."""
    n = len(dfa.trans)
    co = [dfa.accept[s] for s in range(n)]
    changed = True
    while changed:
        changed = False
        for s in range(n):
            if not co[s] and any(co[d] for d in dfa.trans[s].values()):
                co[s] = True
                changed = True
    if not co[0]:
        raise GrammarError("grammar accepts no strings")
    for s in range(n):
        dfa.trans[s] = {ch: d for ch, d in dfa.trans[s].items() if co[d]}
        if not dfa.accept[s] and not dfa.trans[s] and co[s]:
            raise GrammarError("grammar has a dead-end state")


# ---------------------------------------------------------------------------
# schema → AST
# ---------------------------------------------------------------------------


def _json_string_ast(schema: dict[str, Any]) -> _Node:
    lo = int(schema.get("minLength", 0))
    hi = int(schema.get("maxLength", 64))
    if hi <= 0 or hi > 4096:
        raise GrammarError(f"string maxLength {hi} out of range")
    return _seq(_Lit('"'), _rep(_Class(_STRING_CHARS), lo, hi), _Lit('"'))


def _number_ast() -> _Node:
    # Bounded decimal: -?(0|[1-9]\d{0,5})(\.\d{1,4})?
    intpart = _alt(_Lit("0"), _seq(_Class(_DIGITS19), _rep(_Class(_DIGITS), 0, 5)))
    frac = _alt(_seq(_Lit("."), _rep(_Class(_DIGITS), 1, 4)), _Empty())
    return _seq(_alt(_Lit("-"), _Empty()), intpart, frac)


def _schema_ast(schema: dict[str, Any]) -> _Node:
    if "anyOf" in schema:
        # Tagged-union schemas (the action-plan grammar: one object shape
        # per verb).  Each arm must itself be a supported schema; the
        # alternation stays a bounded regular language because every arm is.
        arms = schema["anyOf"]
        if not isinstance(arms, list) or not arms:
            raise GrammarError("anyOf must be a non-empty list of schemas")
        return _alt(*[_schema_ast(arm) for arm in arms])
    if "enum" in schema:
        values = schema["enum"]
        if not values or not all(isinstance(v, str) for v in values):
            raise GrammarError("enum must be a non-empty list of strings")
        return _alt(*[_Lit(json.dumps(v)) for v in values])
    stype = schema.get("type")
    if stype == "string":
        return _json_string_ast(schema)
    if stype == "number":
        return _number_ast()
    if stype == "integer":
        if "minimum" in schema or "maximum" in schema:
            # Bounded integer range as a literal alternation — small ranges
            # only (replica counts, retry budgets), where enumerating keeps
            # the DFA tiny and the admitted set exact.
            lo = int(schema.get("minimum", 0))
            hi = int(schema.get("maximum", lo))
            if hi < lo or hi - lo > 256:
                raise GrammarError(
                    f"integer range [{lo},{hi}] unsupported (span > 256)")
            return _alt(*[_Lit(str(i)) for i in range(lo, hi + 1)])
        return _seq(
            _alt(_Lit("-"), _Empty()),
            _alt(_Lit("0"), _seq(_Class(_DIGITS19), _rep(_Class(_DIGITS), 0, 8))),
        )
    if stype == "boolean":
        return _alt(_Lit("true"), _Lit("false"))
    if stype == "array":
        items = schema.get("items")
        max_items = int(schema.get("maxItems", 8))
        if not isinstance(items, dict):
            raise GrammarError("array schema needs an items schema")
        if max_items <= 0 or max_items > 64:
            raise GrammarError(f"array maxItems {max_items} out of range")
        item = _schema_ast(items)
        body = _alt(
            _seq(item, _rep(_seq(_Lit(","), item), 0, max_items - 1)),
            _Empty(),
        )
        return _seq(_Lit("["), body, _Lit("]"))
    if stype == "object":
        props = schema.get("properties") or {}
        if not props:
            raise GrammarError("object schema needs properties")
        parts: list[_Node] = [_Lit("{")]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts.append(_Lit(","))
            parts.append(_Lit(json.dumps(key) + ":"))
            parts.append(_schema_ast(sub))
        parts.append(_Lit("}"))
        return _seq(*parts)
    raise GrammarError(f"unsupported schema: {schema!r}")


def compile_schema(schema: dict[str, Any]) -> CharDFA:
    """Compile a supported JSON schema into its canonical-form char DFA."""
    nfa = _NFA()
    start = nfa.state()
    final = nfa.build(_schema_ast(schema), start)
    return _determinize(nfa, start, final)


# ---------------------------------------------------------------------------
# token lift
# ---------------------------------------------------------------------------


@dataclass
class TokenFSM:
    """Dense token-transition table the sampler masks against.

    ``trans[s, t]`` = next state after token ``t`` in state ``s``, or -1 when
    ``t`` is disallowed.  Row/state 0 is the FREE state — all tokens allowed,
    self-loop — so one compiled decode program serves batches mixing
    constrained lanes (state >= 1) and unconstrained lanes (state 0).
    Grammar states occupy rows 1..n; accept states self-loop on ``eos_id``
    (and allow nothing else once the char DFA has no outgoing edges), which
    is how a finished verdict forces end-of-sequence.
    """

    trans: np.ndarray  # [n_states + 1, vocab] int32
    start: int
    accept: np.ndarray  # [n_states + 1] bool
    eos_id: int
    max_len: int  # longest accepted token sequence incl. EOS; -1 unbounded

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.trans.shape[1]

    def allowed(self, state: int) -> np.ndarray:
        return self.trans[state] >= 0

    def step(self, state: int, token: int) -> int:
        if state == 0:
            return 0
        if not 0 <= token < self.vocab_size:
            return -1
        return int(self.trans[state, token])

    def walk(self, tokens: Iterable[int], state: int | None = None) -> int:
        """Advance from ``state`` (default: start) through ``tokens``;
        returns -1 once any token is disallowed.  Used at (re-)admission to
        resume a preempted constrained request from its generated-so-far
        suffix."""
        cur = self.start if state is None else state
        for tok in tokens:
            if cur < 0:
                return -1
            cur = self.step(cur, int(tok))
        return cur

    @classmethod
    def from_table(cls, trans: np.ndarray, start: int, accept: np.ndarray,
                   eos_id: int, max_len: int = -1) -> "TokenFSM":
        """Hand-built FSMs (traceguard's toy grammar over a tiny vocab)."""
        trans = np.asarray(trans, dtype=np.int32)
        if trans.ndim != 2 or start < 1 or start >= trans.shape[0]:
            raise GrammarError("bad hand-built FSM table")
        if not np.all(trans[0] == 0):
            raise GrammarError("row 0 must be the all-allowed FREE state")
        return cls(trans=trans, start=start,
                   accept=np.asarray(accept, dtype=bool),
                   eos_id=eos_id, max_len=max_len)


def token_fsm(dfa: CharDFA, *, eos_id: int = _EOS_ID,
              vocab_size: int = _BYTE_VOCAB) -> TokenFSM:
    """Lift a char DFA onto the byte-tokenizer vocab.

    Char ``c`` maps to token ``ord(c) + 3`` (ByteTokenizer); DFA state ``s``
    maps to row ``s + 1`` (row 0 is FREE).  Accept rows gain an ``eos_id``
    self-loop so EOS — and only EOS, once the object is closed — finishes
    the sequence.
    """
    n = len(dfa.trans)
    trans = np.full((n + 1, vocab_size), -1, dtype=np.int32)
    trans[0, :] = 0
    for s, edges in enumerate(dfa.trans):
        for ch, dst in edges.items():
            tok = ord(ch) + _BYTE_OFFSET
            if tok >= vocab_size:
                raise GrammarError(
                    f"char {ch!r} does not fit vocab size {vocab_size}")
            trans[s + 1, tok] = dst + 1
        if dfa.accept[s]:
            trans[s + 1, eos_id] = s + 1
    accept = np.zeros(n + 1, dtype=bool)
    accept[1:] = np.asarray(dfa.accept, dtype=bool)
    chars = dfa.max_path_len()
    return TokenFSM(trans=trans, start=1, accept=accept, eos_id=eos_id,
                    max_len=-1 if chars < 0 else chars + 1)


# ---------------------------------------------------------------------------
# the Verdict schema
# ---------------------------------------------------------------------------

VERDICT_SCHEMA: dict[str, Any] = {
    "type": "object",
    "properties": {
        "severity": {"enum": ["info", "warning", "critical"]},
        "component": {"type": "string", "minLength": 1, "maxLength": 48},
        "root_cause": {"type": "string", "minLength": 1, "maxLength": 160},
        "recommendation": {"type": "string", "minLength": 1, "maxLength": 160},
        "confidence": {"type": "number"},
    },
    "required": ["severity", "component", "root_cause", "recommendation",
                 "confidence"],
}


_VERDICT_DFA: CharDFA | None = None
_VERDICT_FSMS: dict[tuple[int, int], TokenFSM] = {}


def verdict_dfa() -> CharDFA:
    global _VERDICT_DFA
    if _VERDICT_DFA is None:
        _VERDICT_DFA = compile_schema(VERDICT_SCHEMA)
    return _VERDICT_DFA


def verdict_fsm(*, eos_id: int = _EOS_ID,
                vocab_size: int = _BYTE_VOCAB) -> TokenFSM:
    """The cached token FSM for ``VERDICT_SCHEMA``."""
    key = (eos_id, vocab_size)
    fsm = _VERDICT_FSMS.get(key)
    if fsm is None:
        fsm = token_fsm(verdict_dfa(), eos_id=eos_id, vocab_size=vocab_size)
        _VERDICT_FSMS[key] = fsm
    return fsm


def parse_with_dfa(text: str, dfa: CharDFA) -> dict[str, Any]:
    """Validate ``text`` against a compiled grammar, then parse.

    The single sanctioned ``json.loads`` of model output in the tree: the
    char DFA runs first, so anything the constrained sampler could not have
    produced raises ``GrammarError`` instead of reaching the parser.  Every
    schema family funnels through here (``parse_verdict`` for verdicts,
    ``remediation.plans.parse_plan`` for action plans).
    """
    text = text.strip()
    if not dfa.matches(text):
        raise GrammarError(
            f"model output rejected by the grammar: {text[:120]!r}")
    return json.loads(text)


def parse_verdict(text: str, dfa: CharDFA | None = None) -> dict[str, Any]:
    """Validate ``text`` against the verdict grammar, then parse."""
    return parse_with_dfa(text, dfa or verdict_dfa())


def render_verdict(severity: str, component: str, root_cause: str,
                   recommendation: str, confidence: float) -> str:
    """Canonical serialization of a verdict — the TemplateBackend's
    deterministic path, guaranteed to satisfy ``VERDICT_SCHEMA``'s grammar
    (fields are clamped/filtered to the grammar's charset and bounds)."""

    def clean(s: str, max_len: int) -> str:
        out = "".join(ch for ch in s if ch in _STRING_CHARS)[:max_len]
        return out or "n/a"

    if severity not in ("info", "warning", "critical"):
        severity = "warning"
    conf = min(max(float(confidence), 0.0), 1.0)
    return (
        "{" + f'"severity":"{severity}",'
        f'"component":"{clean(component, 48)}",'
        f'"root_cause":"{clean(root_cause, 160)}",'
        f'"recommendation":"{clean(recommendation, 160)}",'
        f'"confidence":{conf:.2f}' + "}"
    )
