"""Constrained decoding: host-side incremental logit-mask builders — a
copy of ``deepspeed_tpu/inference/constrain.py`` (host-only), kept here so
the port imports nothing of the JAX package.

The serving engine's constrained lane (``ServingEngine(logit_masks=True)``)
threads ONE fixed-shape ``[slots, vocab]`` bool operand through the same
captured decode/fused/verify graphs everything else uses — a slot
switching between free and constrained decoding only changes operand
*values*, never graph shapes (no new capture).  The mask itself is
built HERE, on the host, once per scheduler iteration: the engine calls
``mask_builder.allowed(generated_tokens, remaining_budget)`` for every
constrained slot and scatters the returned allow-vector into the operand
row (``ServingEngine._refresh_masks``).  On device the mask is applied
as ``-inf`` *before* temperature/top-k/top-p, so the slot samples (or
argmaxes, at ``temperature == 0``) from the renormalized allowed set.

The protocol is deliberately tiny — anything with an ``allowed(tokens,
remaining) -> bool[vocab]`` method plugs in (regex automata, grammar
tables, tool-call schemas).  :class:`JsonMaskBuilder` is the shipped
reference: a character-level valid-JSON-prefix machine with budget-aware
closing, strong enough to *guarantee* every constrained request's output
parses as JSON:

- a token is allowed iff appending its characters keeps the text a valid
  prefix of a JSON value AND the minimal number of closing characters
  still fits in the remaining token budget (so the stream can always
  finish inside ``max_new_tokens``);
- once the value is complete, ONLY eos is allowed — generation ends at
  a parseable document, never trailing garbage.

By induction the allowed set is never empty before completion: the
closing characters themselves always qualify (each strictly decreases
the minimal-completion count).  The budget arithmetic assumes closing
characters are emittable one per token — true whenever the vocabulary
maps the single JSON punctuation characters to single tokens, which the
char-level tokenization this builder targets does by construction.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["LogitMaskBuilder", "JsonMaskBuilder", "ascii_token_strings"]


class LogitMaskBuilder:
    """Protocol for ``Request.mask_builder`` objects (duck-typed — the
    engine never isinstance-checks): one method, called once per
    scheduler iteration per constrained slot."""

    def allowed(self, tokens: Sequence[int],
                remaining: int) -> np.ndarray:
        """Bool ``[vocab]`` allow-vector given the tokens generated so
        far (resume-folded: preempted/re-homed requests see their full
        generated stream) and the remaining token budget (including the
        token this mask gates)."""
        raise NotImplementedError


def ascii_token_strings(vocab_size: int) -> List[str]:
    """The char-level token table the toy serving models imply: token id
    ``i`` renders as ``chr(i)`` for printable ASCII, empty (= never
    allowed by mask builders) otherwise."""
    return [chr(i) if 32 <= i < 127 else "" for i in range(vocab_size)]


# _JsonPrefix stack frames (top = end of list).  Each frame's CLOSE cost
# is the minimal characters to discharge it: the per-frame costs sum to
# the minimal completion length because continuation frames stay on the
# stack (e.g. a key string's '"' is 1 here; the ':' + value + '}' it
# leads to are billed to the OBJ_COLON frame beneath it).
_CLOSE_COST = {
    "VAL": 1,                  # minimal value: a single digit
    "STR_VAL": 1,              # closing '"'
    "STR_KEY": 1,
    "NUM": 0,                  # already a complete integer
    "NUM-": 1,                 # bare '-': one digit
    "OBJ_KEY_OR_CLOSE": 1,     # '}'
    "OBJ_COLON": 3,            # ':' + minimal value + '}'
    "OBJ_COMMA_OR_CLOSE": 1,   # '}'
    "OBJ_KEY": 5,              # '""' + ':' + minimal value + '}'
    "ARR_FIRST": 1,            # ']'
    "ARR_COMMA_OR_CLOSE": 1,   # ']'
}
_STRING_CHARS = frozenset(
    chr(c) for c in range(32, 127) if chr(c) not in ('"', "\\"))
_LIT_STARTS = {"t": "rue", "f": "alse", "n": "ull"}


class _JsonPrefix:
    """Incremental valid-JSON-prefix machine over the grammar subset
    {object, array, string-without-escapes, integer, true, false, null}.
    ``feed`` returns False on the first character that cannot extend any
    valid JSON value (state is then undefined); ``min_close`` is the
    minimal completion length in characters."""

    __slots__ = ("stack",)

    def __init__(self, stack: Optional[List[str]] = None):
        self.stack = ["VAL"] if stack is None else stack

    def copy(self) -> "_JsonPrefix":
        return _JsonPrefix(list(self.stack))

    @property
    def done(self) -> bool:
        return not self.stack

    def min_close(self) -> int:
        return sum(len(f) - 4 if f.startswith("LIT:") else _CLOSE_COST[f]
                   for f in self.stack)

    def feed(self, ch: str) -> bool:
        stack = self.stack
        while True:
            if not stack:
                return False               # complete value: no trailing chars
            top = stack[-1]
            if top == "VAL":
                stack.pop()
                if ch == "{":
                    stack.append("OBJ_KEY_OR_CLOSE")
                elif ch == "[":
                    stack.append("ARR_FIRST")
                elif ch == '"':
                    stack.append("STR_VAL")
                elif ch.isdigit():
                    if ch != "0":          # JSON bans leading zeros:
                        stack.append("NUM")  # "0" is a complete integer
                elif ch == "-":
                    stack.append("NUM-")
                elif ch in _LIT_STARTS:
                    stack.append("LIT:" + _LIT_STARTS[ch])
                else:
                    return False
                return True
            if top in ("STR_VAL", "STR_KEY"):
                if ch == '"':
                    stack.pop()
                    return True
                return ch in _STRING_CHARS
            if top == "NUM":
                if ch.isdigit():
                    return True
                stack.pop()                # number ends; reprocess ch
                continue
            if top == "NUM-":
                if ch.isdigit():
                    if ch == "0":
                        stack.pop()        # "-0" is a complete integer
                    else:
                        stack[-1] = "NUM"
                    return True
                return False
            if top.startswith("LIT:"):
                rest = top[4:]
                if ch != rest[0]:
                    return False
                if len(rest) == 1:
                    stack.pop()
                else:
                    stack[-1] = "LIT:" + rest[1:]
                return True
            if top == "OBJ_KEY_OR_CLOSE":
                if ch == "}":
                    stack.pop()
                    return True
                if ch == '"':
                    stack[-1] = "OBJ_COLON"
                    stack.append("STR_KEY")
                    return True
                return False
            if top == "OBJ_COLON":
                if ch == ":":
                    stack[-1] = "OBJ_COMMA_OR_CLOSE"
                    stack.append("VAL")
                    return True
                return False
            if top == "OBJ_COMMA_OR_CLOSE":
                if ch == "}":
                    stack.pop()
                    return True
                if ch == ",":
                    stack[-1] = "OBJ_KEY"
                    return True
                return False
            if top == "OBJ_KEY":
                if ch == '"':
                    stack[-1] = "OBJ_COLON"
                    stack.append("STR_KEY")
                    return True
                return False
            if top == "ARR_FIRST":
                if ch == "]":
                    stack.pop()
                    return True
                stack[-1] = "ARR_COMMA_OR_CLOSE"
                stack.append("VAL")
                continue                   # reprocess ch as a value start
            if top == "ARR_COMMA_OR_CLOSE":
                if ch == "]":
                    stack.pop()
                    return True
                if ch == ",":
                    stack.append("VAL")
                    return True
                return False
            raise AssertionError(f"unknown frame {top!r}")


class JsonMaskBuilder(LogitMaskBuilder):
    """Budget-aware valid-JSON mask builder over a char-level token
    table (``token_strings[i]`` is token ``i``'s text; empty strings are
    never allowed).  Incremental: consecutive ``allowed`` calls over a
    growing token stream feed only the new tokens through the prefix
    machine, so per-iteration cost is O(vocab × max_token_chars)."""

    def __init__(self, token_strings: Sequence[str], eos_token_id: int):
        self.tokens = [str(t) for t in token_strings]
        self.vocab = len(self.tokens)
        self.eos = int(eos_token_id)
        if not 0 <= self.eos < self.vocab:
            raise ValueError(
                f"eos_token_id {eos_token_id} outside vocab "
                f"[0, {self.vocab})")
        self._seen: List[int] = []
        self._machine = _JsonPrefix()

    def _advance(self, tokens: Sequence[int]) -> _JsonPrefix:
        toks = [int(t) for t in tokens]
        if toks[:len(self._seen)] != self._seen:
            self._seen, self._machine = [], _JsonPrefix()  # resume/rewind
        for t in toks[len(self._seen):]:
            if t == self.eos:
                break                      # eos ends the stream
            for ch in self.tokens[t]:
                if not self._machine.feed(ch):
                    raise ValueError(
                        f"generated token {t} ({self.tokens[t]!r}) broke "
                        "the JSON prefix — the mask lane must gate every "
                        "emission of a constrained request")
        self._seen = toks
        return self._machine

    def allowed(self, tokens: Sequence[int],
                remaining: int) -> np.ndarray:
        machine = self._advance(tokens)
        mask = np.zeros(self.vocab, bool)
        if machine.done:
            mask[self.eos] = True          # complete document: stop
            return mask
        budget_chars = max(int(remaining) - 1, 0)
        for t, text in enumerate(self.tokens):
            if t == self.eos or not text:
                continue
            m = machine.copy()
            if all(m.feed(ch) for ch in text) \
                    and m.min_close() <= budget_chars:
                mask[t] = True
        return mask
