"""Constraint automata for guided decoding.

Counterpart of ``paddle_tpu/serving/guided.py``, host Python only.
Guided decoding steers the fused step with an additive token mask: each
iteration the engine asks the request's constraint for an f32 row of
0.0 (allowed) / NEG_INF (banned), adds it to the logits before the
log-softmax, and the greedy, sampled or beam choice that follows can
only pick allowed ids. The mask is data, never shape.

A constraint is a pure state machine over token ids:

    state = c.initial_state()
    row   = c.mask_row(state, eos_id)   # np.float32 (V,) additive mask
    state = c.advance(state, token_id)  # None => token violates
    done  = c.accepting(state)          # eos permitted here

States are hashable, and mask rows and token transitions are cached per
state. The eos id is reserved: its mask entry is 0.0 iff the state is
accepting (or no token can extend it, when eos is the only escape),
NEG_INF otherwise.

`ChoiceConstraint` restricts output to one of a fixed set of
alternatives (a trie over vocab strings, or over token-id sequences).
`RegexConstraint` compiles a regex subset (literals, escapes, ``.``,
``[...]``, ``(...)``, ``|``, ``*``, ``+``, ``?``) through a Thompson NFA
into a lazily determinized DFA over characters. `JsonConstraint` is a
character-level JSON pushdown (objects, arrays, strings, numbers,
literals, bounded nesting). `CharConstraint` lifts the character
machines to token ids by walking each vocab string through the machine
once per (state, token) and caching the result.
"""

import numpy as np

from .kv_cache import NEG_INF

__all__ = ["Constraint", "CharConstraint", "TokenChoiceConstraint",
           "ChoiceConstraint", "RegexConstraint", "JsonConstraint"]


class Constraint:
    """Base: hashable-state token automaton + cached mask rows."""

    def __init__(self, vocab_size):
        self._v = int(vocab_size)
        self._row_cache = {}

    @property
    def vocab_size(self):
        return self._v

    def initial_state(self):
        raise NotImplementedError

    def allowed_tokens(self, state):
        """-> np.bool_ (V,): which token ids may be emitted from here."""
        raise NotImplementedError

    def advance(self, state, token):
        """-> successor state, or None when `token` violates."""
        raise NotImplementedError

    def accepting(self, state):
        """True when the output so far is complete (eos permitted)."""
        raise NotImplementedError

    def mask_row(self, state, eos_id=None):
        """Additive f32 mask (V,): 0.0 allowed / NEG_INF banned. The
        returned array is cached and shared — callers must not mutate
        it. When NO token is allowed and the state is not accepting
        (an exhausted constraint), eos becomes the only escape so the
        lane can retire instead of wedging."""
        key = (state, eos_id)
        row = self._row_cache.get(key)
        if row is not None:
            return row
        allowed = self.allowed_tokens(state)
        row = np.where(allowed, np.float32(0.0),
                       np.float32(NEG_INF)).astype(np.float32)
        if eos_id is not None and 0 <= int(eos_id) < row.size:
            if self.accepting(state) or not bool(allowed.any()):
                row[int(eos_id)] = 0.0
            else:
                row[int(eos_id)] = np.float32(NEG_INF)
        row.setflags(write=False)
        self._row_cache[key] = row
        return row


# ---------------------------------------------------------------------------
# Character machines (internal): start() / step(state, ch) / accepting(state)
# ---------------------------------------------------------------------------

class _TrieMachine:
    """Characters of a fixed set of alternative strings."""

    def __init__(self, choices):
        self._kids = [{}]    # node -> {ch: node}
        self._term = set()
        for s in choices:
            node = 0
            for ch in s:
                node = self._kids[node].setdefault(ch, self._new())
            self._term.add(node)

    def _new(self):
        self._kids.append({})
        return len(self._kids) - 1

    def start(self):
        return 0

    def step(self, state, ch):
        return self._kids[state].get(ch)

    def accepting(self, state):
        return state in self._term


_RX_DIGITS = frozenset("0123456789")
_RX_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_RX_SPACE = frozenset(" \t\n\r\f\v")


class _RxParser:
    """Recursive-descent regex-subset parser -> AST tuples."""

    def __init__(self, pattern):
        self._p = pattern
        self._i = 0

    def parse(self):
        node = self._alt()
        if self._i != len(self._p):
            raise ValueError("unbalanced pattern: %r" % (self._p,))
        return node

    def _peek(self):
        return self._p[self._i] if self._i < len(self._p) else None

    def _alt(self):
        node = self._concat()
        while self._peek() == "|":
            self._i += 1
            node = ("alt", node, self._concat())
        return node

    def _concat(self):
        node = None
        while self._peek() not in (None, "|", ")"):
            piece = self._repeat()
            node = piece if node is None else ("cat", node, piece)
        return node if node is not None else ("eps",)

    def _repeat(self):
        node = self._atom()
        while self._peek() in ("*", "+", "?"):
            op = self._p[self._i]
            self._i += 1
            node = ({"*": "star", "+": "plus", "?": "opt"}[op], node)
        return node

    def _atom(self):
        ch = self._peek()
        if ch is None:
            raise ValueError("dangling pattern: %r" % (self._p,))
        if ch == "(":
            self._i += 1
            node = self._alt()
            if self._peek() != ")":
                raise ValueError("unclosed group: %r" % (self._p,))
            self._i += 1
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            self._i += 1
            return ("any",)
        if ch == "\\":
            self._i += 1
            return self._escape()
        if ch in "*+?)|":
            raise ValueError("misplaced %r in %r" % (ch, self._p))
        self._i += 1
        return ("lit", ch)

    def _escape(self):
        if self._i >= len(self._p):
            raise ValueError("trailing backslash: %r" % (self._p,))
        ch = self._p[self._i]
        self._i += 1
        if ch == "d":
            return ("class", _RX_DIGITS, False)
        if ch == "w":
            return ("class", _RX_WORD, False)
        if ch == "s":
            return ("class", _RX_SPACE, False)
        if ch == "n":
            return ("lit", "\n")
        if ch == "t":
            return ("lit", "\t")
        return ("lit", ch)

    def _char_class(self):
        self._i += 1                                     # consume '['
        negated = self._peek() == "^"
        if negated:
            self._i += 1
        chars = set()
        while True:
            ch = self._peek()
            if ch is None:
                raise ValueError("unclosed class: %r" % (self._p,))
            if ch == "]":
                self._i += 1
                return ("class", frozenset(chars), negated)
            if ch == "\\":
                self._i += 1
                node = self._escape()
                if node[0] == "lit":
                    chars.add(node[1])
                else:
                    chars |= node[1]
                continue
            self._i += 1
            if self._peek() == "-" and self._i + 1 < len(self._p) \
                    and self._p[self._i + 1] != "]":
                hi = self._p[self._i + 1]
                self._i += 2
                for o in range(ord(ch), ord(hi) + 1):
                    chars.add(chr(o))
            else:
                chars.add(ch)


class _RegexMachine:
    """Thompson NFA -> lazily-determinized DFA over characters. DFA
    states are frozensets of NFA states; transitions cache per
    (dfa_state, ch) so mask construction amortizes to dict hits."""

    def __init__(self, pattern):
        self.pattern = pattern
        self._eps = {}       # nfa state -> [nfa states]
        self._chars = {}     # nfa state -> [(matcher, nfa state)]
        self._n = 0
        start, end = self._build(_RxParser(pattern).parse())
        self._accept = end
        self._start = self._closure(frozenset([start]))
        self._steps = {}

    def _new(self):
        s = self._n
        self._n += 1
        self._eps[s] = []
        self._chars[s] = []
        return s

    def _build(self, node):
        kind = node[0]
        if kind in ("lit", "any", "class"):
            s, e = self._new(), self._new()
            self._chars[s].append((node, e))
            return s, e
        if kind == "eps":
            s = self._new()
            return s, s
        if kind == "cat":
            s1, e1 = self._build(node[1])
            s2, e2 = self._build(node[2])
            self._eps[e1].append(s2)
            return s1, e2
        if kind == "alt":
            s, e = self._new(), self._new()
            for sub in (node[1], node[2]):
                ss, se = self._build(sub)
                self._eps[s].append(ss)
                self._eps[se].append(e)
            return s, e
        if kind == "star":
            s, e = self._new(), self._new()
            ss, se = self._build(node[1])
            self._eps[s] += [ss, e]
            self._eps[se] += [ss, e]
            return s, e
        if kind == "plus":
            ss, se = self._build(node[1])
            e = self._new()
            self._eps[se] += [ss, e]
            return ss, e
        if kind == "opt":
            s, e = self._new(), self._new()
            ss, se = self._build(node[1])
            self._eps[s] += [ss, e]
            self._eps[se].append(e)
            return s, e
        raise AssertionError(kind)

    @staticmethod
    def _match(matcher, ch):
        if matcher[0] == "lit":
            return ch == matcher[1]
        if matcher[0] == "any":
            return True
        return (ch in matcher[1]) != matcher[2]          # class, negated

    def _closure(self, states):
        seen = set(states)
        stack = list(states)
        while stack:
            for t in self._eps[stack.pop()]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def start(self):
        return self._start

    def step(self, state, ch):
        key = (state, ch)
        if key in self._steps:
            return self._steps[key]
        nxt = set()
        for s in state:
            for matcher, t in self._chars[s]:
                if self._match(matcher, ch):
                    nxt.add(t)
        out = self._closure(nxt) if nxt else None
        self._steps[key] = out
        return out

    def accepting(self, state):
        return self._accept in state


_JSON_WS = " \t\n\r"
_JSON_NUM_DONE = frozenset(("int0", "int", "frac", "exp"))


class _JsonMachine:
    """Character-level JSON pushdown. State = (phase, stack, aux) with
    stack a tuple of open containers — hashable, so the token-level
    caches in CharConstraint apply per distinct parse context."""

    def __init__(self, max_depth=16):
        self._max_depth = int(max_depth)

    def start(self):
        return ("val", (), None)

    def accepting(self, state):
        phase, stack, aux = state
        if phase == "end":
            return True
        return phase == "num" and not stack and aux in _JSON_NUM_DONE

    def _close(self, stack):
        if not stack:
            return ("end", (), None)
        if stack[-1] == "{":
            return ("obj_next", stack, None)
        return ("arr_next", stack, None)

    def step(self, state, ch):
        phase, stack, aux = state
        if phase == "val" or phase == "arr_first":
            if ch in _JSON_WS:
                return state
            if phase == "arr_first" and ch == "]":
                return self._close(stack[:-1])
            if ch == '"':
                return ("str", stack, None)
            if ch == "{":
                if len(stack) >= self._max_depth:
                    return None
                return ("obj_first", stack + ("{",), None)
            if ch == "[":
                if len(stack) >= self._max_depth:
                    return None
                return ("arr_first", stack + ("[",), None)
            if ch == "t":
                return ("lit", stack, "rue")
            if ch == "f":
                return ("lit", stack, "alse")
            if ch == "n":
                return ("lit", stack, "ull")
            if ch == "-":
                return ("num", stack, "neg")
            if ch == "0":
                return ("num", stack, "int0")
            if ch in "123456789":
                return ("num", stack, "int")
            return None
        if phase == "lit":
            if ch == aux[0]:
                rest = aux[1:]
                return ("lit", stack, rest) if rest else self._close(stack)
            return None
        if phase in ("str", "key"):
            if ch == '"':
                return (("colon", stack, None) if phase == "key"
                        else self._close(stack))
            if ch == "\\":
                return (phase + "_esc", stack, None)
            if ord(ch) < 0x20:
                return None
            return state
        if phase in ("str_esc", "key_esc"):
            base = phase[:-4]
            if ch in '"\\/bfnrt':
                return (base, stack, None)
            if ch == "u":
                return (base + "_u", stack, 4)
            return None
        if phase in ("str_u", "key_u"):
            if ch in "0123456789abcdefABCDEF":
                n = aux - 1
                base = phase[:-2]
                return (base, stack, None) if n == 0 else (phase, stack, n)
            return None
        if phase == "num":
            nxt = self._num_step(aux, ch)
            if nxt is not None:
                return ("num", stack, nxt)
            if aux in _JSON_NUM_DONE:
                return self.step(self._close(stack), ch)
            return None
        if phase == "obj_first":
            if ch in _JSON_WS:
                return state
            if ch == "}":
                return self._close(stack[:-1])
            if ch == '"':
                return ("key", stack, None)
            return None
        if phase == "colon":
            if ch in _JSON_WS:
                return state
            if ch == ":":
                return ("val", stack, None)
            return None
        if phase == "obj_next":
            if ch in _JSON_WS:
                return state
            if ch == ",":
                return ("obj_key", stack, None)
            if ch == "}":
                return self._close(stack[:-1])
            return None
        if phase == "obj_key":
            if ch in _JSON_WS:
                return state
            if ch == '"':
                return ("key", stack, None)
            return None
        if phase == "arr_next":
            if ch in _JSON_WS:
                return state
            if ch == ",":
                return ("val", stack, None)
            if ch == "]":
                return self._close(stack[:-1])
            return None
        if phase == "end":
            return state if ch in _JSON_WS else None
        raise AssertionError(phase)

    @staticmethod
    def _num_step(aux, ch):
        if aux == "neg":
            if ch == "0":
                return "int0"
            if ch in "123456789":
                return "int"
            return None
        if aux == "int0":
            if ch == ".":
                return "dot"
            if ch in "eE":
                return "e"
            return None
        if aux == "int":
            if ch in "0123456789":
                return "int"
            if ch == ".":
                return "dot"
            if ch in "eE":
                return "e"
            return None
        if aux == "dot":
            return "frac" if ch in "0123456789" else None
        if aux == "frac":
            if ch in "0123456789":
                return "frac"
            if ch in "eE":
                return "e"
            return None
        if aux == "e":
            if ch in "0123456789":
                return "exp"
            if ch in "+-":
                return "esign"
            return None
        if aux == "esign":
            return "exp" if ch in "0123456789" else None
        if aux == "exp":
            return "exp" if ch in "0123456789" else None
        return None


# ---------------------------------------------------------------------------
# Token-level constraints
# ---------------------------------------------------------------------------

class CharConstraint(Constraint):
    """Lift a character machine to token ids: a token is allowed from a
    state iff walking its vocab string through the machine stays live.
    Per-state (allowed, successor) tables are computed once and cached;
    empty-string tokens are never allowed (no silent non-progress)."""

    def __init__(self, machine, vocab):
        super().__init__(len(vocab))
        self._machine = machine
        self._vocab = [None if s is None else str(s) for s in vocab]
        self._tables = {}    # state -> (allowed np.bool_ (V,), {tid: state})

    def initial_state(self):
        return self._machine.start()

    def _table(self, state):
        t = self._tables.get(state)
        if t is None:
            allowed = np.zeros((self._v,), np.bool_)
            succ = {}
            step = self._machine.step
            for tid, s in enumerate(self._vocab):
                if not s:
                    continue
                cur = state
                for ch in s:
                    cur = step(cur, ch)
                    if cur is None:
                        break
                if cur is not None:
                    allowed[tid] = True
                    succ[tid] = cur
            t = (allowed, succ)
            self._tables[state] = t
        return t

    def allowed_tokens(self, state):
        return self._table(state)[0]

    def advance(self, state, token):
        return self._table(state)[1].get(int(token))

    def accepting(self, state):
        return self._machine.accepting(state)


class TokenChoiceConstraint(Constraint):
    """Trie directly over token-id sequences (no vocab needed)."""

    def __init__(self, sequences, vocab_size):
        super().__init__(vocab_size)
        self._kids = [{}]
        self._term = set()
        for seq in sequences:
            node = 0
            for tid in seq:
                node = self._kids[node].setdefault(int(tid), self._new())
            self._term.add(node)
        self._allowed = {}

    def _new(self):
        self._kids.append({})
        return len(self._kids) - 1

    def initial_state(self):
        return 0

    def allowed_tokens(self, state):
        a = self._allowed.get(state)
        if a is None:
            a = np.zeros((self._v,), np.bool_)
            for tid in self._kids[state]:
                if 0 <= tid < self._v:
                    a[tid] = True
            self._allowed[state] = a
        return a

    def advance(self, state, token):
        return self._kids[state].get(int(token))

    def accepting(self, state):
        return state in self._term


def ChoiceConstraint(choices, vocab=None, vocab_size=None):
    """Restrict output to one of `choices`. With `vocab` (list of token
    strings indexed by id) the choices are strings and ANY tokenization
    spelling a choice is accepted; with `vocab_size` the choices are
    token-id sequences matched exactly."""
    if vocab is not None:
        return CharConstraint(_TrieMachine([str(c) for c in choices]),
                              vocab)
    if vocab_size is None:
        raise ValueError("ChoiceConstraint needs vocab= or vocab_size=")
    return TokenChoiceConstraint(choices, vocab_size)


class RegexConstraint(CharConstraint):
    """Output must match `pattern` (regex subset: literals, escapes
    \\d \\w \\s, ``.``, ``[...]``/``[^...]`` with ranges, groups,
    ``|``, ``*``, ``+``, ``?``). eos is allowed exactly when the text
    so far is a complete match."""

    def __init__(self, pattern, vocab):
        super().__init__(_RegexMachine(pattern), vocab)
        self.pattern = pattern


class JsonConstraint(CharConstraint):
    """Output must be one well-formed JSON value (objects, arrays,
    strings with escapes, numbers, true/false/null; nesting bounded by
    `max_depth`). eos is allowed once the value closes."""

    def __init__(self, vocab, max_depth=16):
        super().__init__(_JsonMachine(max_depth), vocab)
