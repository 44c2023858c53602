"""Row-pattern matching (MATCH_RECOGNIZE) as a vectorized DFA scan.

Torch port of ``presto_tpu/ops/pattern.py``, the redesign of the
reference's per-partition backtracking matcher
(``operator/window/PatternRecognitionPartition.java`` + the
``sql/planner/rowpattern/`` IR): the pattern compiles on the host, once
per query, to

    regex over symbols -> Thompson NFA -> subset-construction DFA

whose input alphabet is a row's PREDICATE BITMASK (bit s = symbol s's
DEFINE predicate holds).  On the device:

1. every DEFINE predicate evaluates vectorized into one int32 code per
   row (``exec/physical.py``);
2. every candidate start row advances its own DFA copy in lockstep, one
   elementwise step per row of match length (``match_lengths``): the
   leftmost-longest match length of every start at once; the steps stop
   once every copy is dead, read on the host every few steps;
3. AFTER MATCH SKIP PAST LAST ROW (``select_matches``): a match never
   crosses a partition, so each partition's first candidate is taken and
   one cursor per partition hops past each match to the next candidate,
   all partitions in lockstep: as many steps as the busiest partition
   has matches (the JAX package's ``while_loop`` visits every row).

Semantics: leftmost-longest matches, equal to the reference's greedy
quantifiers for concatenation, ``+``, ``*`` and ``?`` patterns; an empty
match (a pattern that accepts no rows) is not reported.  The pattern AST
and ``compile_pattern`` are a copy of the JAX package's jax-free half.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from ..utils.tracing import host_read

DEAD = 0  # DFA dead state is always index 0


# ----------------------------------------------------------- pattern AST

@dataclass(frozen=True)
class Sym:
    name: str


@dataclass(frozen=True)
class Seq:
    parts: Tuple[object, ...]


@dataclass(frozen=True)
class Alt:
    options: Tuple[object, ...]


@dataclass(frozen=True)
class Quant:
    arg: object
    kind: str  # '+', '*', '?'


# ------------------------------------------------------- NFA construction

class _NFA:
    def __init__(self):
        self.eps: List[set] = []
        self.edges: List[Dict[int, set]] = []  # state -> {symbol: {states}}

    def new(self) -> int:
        self.eps.append(set())
        self.edges.append({})
        return len(self.eps) - 1


def _build(nfa: _NFA, node, symbols: Dict[str, int]) -> Tuple[int, int]:
    """Thompson construction → (start, accept) state pair."""
    if isinstance(node, Sym):
        s, a = nfa.new(), nfa.new()
        nfa.edges[s].setdefault(symbols[node.name], set()).add(a)
        return s, a
    if isinstance(node, Seq):
        s0, a0 = _build(nfa, node.parts[0], symbols)
        for p in node.parts[1:]:
            s1, a1 = _build(nfa, p, symbols)
            nfa.eps[a0].add(s1)
            a0 = a1
        return s0, a0
    if isinstance(node, Alt):
        s, a = nfa.new(), nfa.new()
        for opt in node.options:
            so, ao = _build(nfa, opt, symbols)
            nfa.eps[s].add(so)
            nfa.eps[ao].add(a)
        return s, a
    if isinstance(node, Quant):
        si, ai = _build(nfa, node.arg, symbols)
        s, a = nfa.new(), nfa.new()
        nfa.eps[s].add(si)
        if node.kind in ("*", "?"):
            nfa.eps[s].add(a)
        nfa.eps[ai].add(a)
        if node.kind in ("*", "+"):
            nfa.eps[ai].add(si)
        return s, a
    raise ValueError(f"bad pattern node {node!r}")


def _eclose(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    out = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in out:
                out.add(t)
                stack.append(t)
    return frozenset(out)


@dataclass
class CompiledPattern:
    symbols: Tuple[str, ...]          # bit order of the predicate mask
    table: np.ndarray                 # [n_states, 2^k] int32 DFA transitions
    accepting: np.ndarray             # [n_states] bool
    start: int

    @property
    def n_states(self) -> int:
        return self.table.shape[0]


def compile_pattern(node, symbols: List[str]) -> CompiledPattern:
    """Pattern AST + symbol order → DFA over predicate bitmasks.

    A row whose predicate mask has bit s set may act as symbol s; the DFA
    input is the full mask, so subset construction resolves 'which symbol
    does this row play' exactly like the reference explores alternatives."""
    k = len(symbols)
    assert k <= 8, "at most 8 pattern symbols"
    sym_ids = {s: i for i, s in enumerate(symbols)}
    nfa = _NFA()
    start, accept = _build(nfa, node, sym_ids)

    start_set = _eclose(nfa, frozenset([start]))
    dfa_states: Dict[FrozenSet[int], int] = {frozenset(): DEAD,
                                             start_set: 1}
    rows: List[List[int]] = [[DEAD] * (1 << k),   # dead state loops
                             [0] * (1 << k)]
    accepting = [False, accept in start_set]
    work = [start_set]
    while work:
        cur = work.pop()
        ci = dfa_states[cur]
        for mask in range(1 << k):
            nxt = set()
            for st in cur:
                for sym, targets in nfa.edges[st].items():
                    if mask & (1 << sym):
                        nxt.update(targets)
            closed = _eclose(nfa, frozenset(nxt)) if nxt else frozenset()
            di = dfa_states.get(closed)
            if di is None:
                di = len(rows)
                dfa_states[closed] = di
                rows.append([DEAD] * (1 << k))
                accepting.append(accept in closed)
                work.append(closed)
            rows[ci][mask] = di
    return CompiledPattern(tuple(symbols),
                           np.asarray(rows, np.int32),
                           np.asarray(accepting, bool), 1)


# ------------------------------------------------------------ device match

STEPS_PER_CHECK = 8  # lockstep steps between host reads of "any live?"


def _read(t: torch.Tensor) -> int:
    with host_read():
        return int(t.item())


def match_lengths(codes: torch.Tensor, new_part: torch.Tensor,
                  pat: CompiledPattern, window: int = 256,
                  read=_read) -> torch.Tensor:
    """Each start row's leftmost-longest match length (int32, 0 = no
    match), at most ``window`` rows.  ``codes`` is each row's predicate
    bitmask (-1 for a masked-out row); ``new_part`` marks partition
    starts: a match in flight dies where it would cross into the next
    partition.  A dead DFA copy stays dead, so the steps stop early once
    none is live (``read``, the host read of a device scalar, every
    STEPS_PER_CHECK steps); the lengths are those of all ``window``
    steps."""
    n = codes.shape[0]
    dev = codes.device
    width = pat.table.shape[1]
    table = torch.from_numpy(pat.table.reshape(-1).astype(np.int64)).to(dev)
    acc = torch.from_numpy(pat.accepting).to(dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    states = torch.full((n,), pat.start, dtype=torch.int64, device=dev)
    best = torch.zeros((n,), dtype=torch.int32, device=dev)
    codes = codes.to(torch.int64)
    for j in range(window):
        pos = idx + j
        inb = pos < n
        at = pos.clamp(max=max(n - 1, 0))
        code = torch.where(inb, codes[at], -1)
        if j > 0:
            code = torch.where(new_part[at], -1, code)
        states = torch.where(code >= 0,
                             table[states * width + code.clamp(min=0)], DEAD)
        best = torch.where(acc[states], j + 1, best)
        if (j + 1) % STEPS_PER_CHECK == 0 \
                and not read((states != DEAD).any()):
            break
    return best


def _next_at_or_after(flags: torch.Tensor) -> torch.Tensor:
    """[n + 1]: the first index >= i where ``flags`` is set (n if none),
    and n at position n: a reverse running minimum."""
    n = flags.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=flags.device)
    first = torch.where(flags, idx, n).flip(0).cummin(0).values.flip(0)
    return torch.cat([first, first.new_full((1,), n)])


def select_matches(mlen: torch.Tensor, mask: torch.Tensor,
                   new_part: torch.Tensor, read=_read) -> torch.Tensor:
    """AFTER MATCH SKIP PAST LAST ROW: bool [n], the starts of the matches
    taken, as a left-to-right scan takes them (a live start with a match,
    then the first such start past its last row).  One cursor per
    partition (``read`` of their count), stepped in lockstep:
    ``cursor <- next candidate at or after cursor + mlen[cursor]`` until
    it leaves its partition, with a ``read`` of "any cursor left?" every
    STEPS_PER_CHECK steps."""
    n = mlen.shape[0]
    dev = mlen.device
    cand = mask & (mlen > 0)
    nxt = _next_at_or_after(cand)
    step_len = torch.cat([mlen.to(torch.int64),
                          torch.zeros((1,), dtype=torch.int64, device=dev)])
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    starts = torch.sort(torch.where(new_part, idx, n)).values[
        :read(new_part.sum())]
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    cur = nxt[starts]
    sel = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    step = 0
    while True:
        live = cur < ends
        sel[torch.where(live, cur, n)] = True
        cur = torch.where(live, nxt[(cur + step_len[cur]).clamp(max=n)], n)
        step += 1
        if step % STEPS_PER_CHECK == 0 and not read((cur < ends).any()):
            break
    return sel[:n]
