"""Posterior-pair multiple sequence alignment: the multipleAligner equivalent.

Mirrors impl/multipleAligner.c: pairwise posterior alignments over a chosen
set of sequence pairs (all pairs for small inputs, spanning trees otherwise,
getReferencePairwiseAlignments :740 / makeAlignment :892-944), then greedy
maximum-weight column merging constrained to keep a valid partial order of
columns (getMultipleSequenceAlignment :272; the poset safeguard is implemented
as a cycle check over the column-precedence DAG), and a filter retaining the
pairs consistent with the columns (filterMultipleAlignedPairs), which for two
sequences is the consistency filter used by the realigner
(filterPairwiseAlignmentToMakePairsOrdered :949-997).

Port of ``cpecan_signal_tpu/msa.py``: the same code over the port's
engine/align.align_sequence_pair (the f64 oracle), whose pairwise alignments
run on one device, the card unless the caller asks for the CPU
(``make_alignment(device=...)``).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from .engine.align import align_sequence_pair
from .models.params import AlignmentParams
from .models.state_machines import bind_symbol_sequences, make_symbol_sm5
from .utils.device import resolve_device


@dataclass
class MultipleAlignment:
    """Columns of (seq_idx, position) plus the consistent pairwise pairs."""

    columns: list[set[tuple[int, int]]]
    consistent_pairs: list[tuple[int, int, int, int, int]]  # (w, s1, p1, s2, p2)
    pairwise_pairs: list[tuple[int, int, int, int, int]]


class _ColumnPoset:
    """Union-find over (seq, pos) with a precedence-cycle safeguard
    (the stPosetAlignment role)."""

    def __init__(self, seq_lengths: list[int]):
        self.parent: dict[tuple[int, int], tuple[int, int]] = {}
        self.members: dict[tuple[int, int], set[tuple[int, int]]] = {}
        self.seq_lengths = seq_lengths

    def find(self, key):
        if key not in self.parent:
            self.parent[key] = key
            self.members[key] = {key}
            return key
        root = key
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[key] != root:
            self.parent[key], key = root, self.parent[key]
        return root

    def _succ_columns(self, root):
        """Columns that must come strictly after ``root``: for each member
        (s, p), the column of the next aligned position of s."""
        out = set()
        for (s, p) in self.members[root]:
            q = p + 1
            while q < self.seq_lengths[s]:
                key = (s, q)
                if key in self.parent:
                    out.add(self.find(key))
                    break
                q += 1
        return out

    def _reaches(self, start_roots, target, limit=10000):
        seen = set()
        stack = list(start_roots)
        while stack and len(seen) < limit:
            r = stack.pop()
            if r == target:
                return True
            if r in seen:
                continue
            seen.add(r)
            stack.extend(self._succ_columns(r))
        return False

    def can_merge(self, a, b) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return True
        sa = {s for s, _ in self.members[ra]}
        sb = {s for s, _ in self.members[rb]}
        if sa & sb:
            return False  # two positions of one sequence in one column
        # merging must not create a precedence cycle: rb must not be reachable
        # from ra's successors and vice versa
        if self._reaches(self._succ_columns(ra), rb):
            return False
        if self._reaches(self._succ_columns(rb), ra):
            return False
        return True

    def merge(self, a, b) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return True
        if not self.can_merge(a, b):
            return False
        self.parent[rb] = ra
        self.members[ra] |= self.members.pop(rb)
        return True

    def same(self, a, b) -> bool:
        return self.find(a) == self.find(b)

    def column_sets(self):
        return [set(v) for k, v in self.members.items() if self.find(k) == k]


def _reference_pairwise_alignments(seqs: list[str]) -> list[tuple[int, int]]:
    """Initial connected pair set (getReferencePairwiseAlignments,
    multipleAligner.c:740-775): sequences ordered by length, every sequence
    aligned to the middle-length reference sequence (star topology; the
    reference's rightEndId grouping degenerates to one group here since the
    MSA entry points construct SeqFrags with end id 0)."""
    n = len(seqs)
    if n <= 1:
        return []
    order = sorted(range(n), key=lambda i: (len(seqs[i]), i))
    ref = order[n // 2]
    return [(min(ref, m), max(ref, m)) for m in order if m != ref]


def _greedy_columns(seqs, all_pairs, match_gamma: float) -> _ColumnPoset:
    """Greedy maximum-weight column merging with the poset safeguard
    (getMultipleSequenceAlignment, multipleAligner.c:272-297); stops merging
    pairs below the matchGamma weight threshold."""
    from .constants import PAIR_ALIGNMENT_PROB_1
    poset = _ColumnPoset([len(s) for s in seqs])
    thresh = match_gamma * PAIR_ALIGNMENT_PROB_1
    for w, s1, p1, s2, p2 in sorted(all_pairs, key=lambda t: -t[0]):
        if w < thresh:
            break
        poset.merge((s1, p1), (s2, p2))
    return poset


def _progressive_columns(seqs, all_pairs, pair_scores, match_gamma: float
                         ) -> _ColumnPoset:
    """Progressive merging (getMultipleSequenceAlignmentProgressive,
    multipleAligner.c:510-560): components are merged most-similar-first;
    each merge max-weight-aligns the two paired sequences' column sequences
    (pairwiseAlignColumns :383-470, here a weighted LCS DP over column
    indices) and joins matched columns through the poset guard."""
    from .constants import PAIR_ALIGNMENT_PROB_1
    poset = _ColumnPoset([len(s) for s in seqs])
    thresh = match_gamma * PAIR_ALIGNMENT_PROB_1

    # pair weights keyed by sequence pair for the column-column DP
    by_pair: dict[tuple[int, int], list[tuple[int, int, int]]] = defaultdict(list)
    for w, s1, p1, s2, p2 in all_pairs:
        by_pair[(s1, s2)].append((w, p1, p2))
        by_pair[(s2, s1)].append((w, p2, p1))

    comp: dict[int, int] = {i: i for i in range(len(seqs))}

    def find_comp(i):
        while comp[i] != i:
            comp[i] = comp[comp[i]]
            i = comp[i]
        return i

    for _score, sx, sy in sorted(pair_scores, reverse=True):
        if find_comp(sx) == find_comp(sy):
            continue
        comp[find_comp(sy)] = find_comp(sx)
        pairs = [t for t in by_pair.get((sx, sy), ()) if t[0] >= thresh]
        if not pairs:
            continue
        # weighted-LIS over (p1, p2): the max-weight monotone matching of the
        # two column sequences (both components are disjoint, so any monotone
        # matching of the representatives is order-safe; the poset guard
        # handles residual cross-component constraints)
        pairs.sort(key=lambda t: (t[1], t[2]))
        ws = np.asarray([t[0] for t in pairs], dtype=np.float64)
        p2s = [t[2] for t in pairs]
        best = np.zeros(len(pairs))
        back = np.full(len(pairs), -1, dtype=np.int64)
        for i in range(len(pairs)):
            best[i] = ws[i]
            for j in range(i):
                if pairs[j][1] < pairs[i][1] and p2s[j] < p2s[i]:
                    cand = best[j] + ws[i]
                    if cand > best[i]:
                        best[i] = cand
                        back[i] = j
        i = int(np.argmax(best))
        chain = []
        while i >= 0:
            chain.append(pairs[i])
            i = int(back[i])
        for w, p1, p2 in chain:
            poset.merge((sx, p1), (sy, p2))
    return poset


def _distance_counts(columns, seqs, max_pairs_to_consider: int):
    """Substitution / identity counts from the MSA columns (getDistanceMatrix,
    multipleAligner.c:817-848)."""
    n = len(seqs)
    subs = np.zeros((n, n), dtype=np.int64)
    nonsubs = np.zeros((n, n), dtype=np.int64)
    considered = 0
    for col in columns:
        members = sorted(col)
        for a in range(len(members)):
            s1, p1 = members[a]
            for b in range(a + 1, len(members)):
                s2, p2 = members[b]
                if seqs[s1][p1] == seqs[s2][p2]:
                    nonsubs[s1, s2] += 1
                    nonsubs[s2, s1] += 1
                else:
                    subs[s1, s2] += 1
                    subs[s2, s1] += 1
                considered += 1
        if considered >= max_pairs_to_consider:
            break
    return subs, nonsubs


def _subs_per_site(i, j, subs, nonsubs) -> float:
    t = subs[i, j] + nonsubs[i, j]
    return 0.0 if t == 0 else subs[i, j] / float(t)


def _next_best_pair(seq1: int, subs, nonsubs, chosen: set, n: int,
                    rng) -> int | None:
    """Best next alignment partner for seq1: max gain between the current
    alignment-path distance (Dijkstra over chosen pairs weighted subs/site)
    and the direct pairwise distance (getNextBestPair,
    multipleAligner.c:866-891)."""
    import heapq
    adj = defaultdict(list)
    for (a, b) in chosen:
        w = _subs_per_site(a, b, subs, nonsubs)
        adj[a].append((b, w))
        adj[b].append((a, w))
    dist = {seq1: 0.0}
    heap = [(0.0, seq1)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist.get(u, np.inf):
            continue
        for v, w in adj[u]:
            nd = d + w
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    max_gain, best = -np.inf, None
    for seq2 in range(n):
        if seq2 == seq1 or (min(seq1, seq2), max(seq1, seq2)) in chosen:
            continue
        gain = dist.get(seq2, np.inf) - _subs_per_site(seq1, seq2, subs, nonsubs)
        if gain > max_gain or (gain == max_gain and rng.random() > 0.5):
            max_gain, best = gain, seq2
    return best


def make_alignment(seqs: list[str], spanning_trees: int = 2,
                   max_pairs_to_consider: int = 10000,
                   params: AlignmentParams | None = None,
                   match_gamma: float = 0.0,
                   use_progressive_merging: bool = False,
                   seed: int = 0, device: torch.device | None = None) -> MultipleAlignment:
    """Posterior-pair MSA (makeAlignment, multipleAligner.c:892-944): initial
    spanning tree of pairwise alignments, then ``spanning_trees - 1`` rounds
    of distance-matrix-guided extra alignments (Dijkstra gain selection),
    merging columns greedily or progressively; the pairwise alignments run
    on ``device`` (default: the resolved device)."""
    from .anchor.seed_chain import get_anchor_pairs_for_params

    device = resolve_device() if device is None else device
    params = params or AlignmentParams()
    rng = np.random.default_rng(seed)
    n = len(seqs)
    all_pairs: list[tuple[int, int, int, int, int]] = []
    pair_scores: list[tuple[int, int, int]] = []

    def mk(sx, sy):
        sm = make_symbol_sm5()
        bind_symbol_sequences(sm, sx, sy)
        return sm

    def add_alignment(i, j):
        anchors = get_anchor_pairs_for_params(seqs[i], seqs[j], params)
        ap = align_sequence_pair(mk, seqs[i], seqs[j], anchors, params, device=device)
        cnt = 0
        for w, x, y in ap.as_tuples():
            all_pairs.append((w, i, int(x), j, int(y)))
            cnt += 1
        pair_scores.append((cnt, i, j))

    all_mode = n < 2 or spanning_trees * (n - 1) >= n * (n - 1) // 2
    if all_mode:
        chosen = {(i, j) for i in range(n) for j in range(i + 1, n)}
    else:
        chosen = set(_reference_pairwise_alignments(seqs))
    for (i, j) in sorted(chosen):
        add_alignment(i, j)

    progressive = use_progressive_merging or n == 2
    iteration = 0
    while True:
        poset = (_progressive_columns(seqs, all_pairs, pair_scores, match_gamma)
                 if progressive else
                 _greedy_columns(seqs, all_pairs, match_gamma))
        iteration += 1
        if all_mode or iteration >= spanning_trees:
            break
        subs, nonsubs = _distance_counts(poset.column_sets(), seqs,
                                         max_pairs_to_consider)
        for seq in range(n):
            other = _next_best_pair(seq, subs, nonsubs, chosen, n, rng)
            if other is not None:
                pair = (min(seq, other), max(seq, other))
                chosen.add(pair)
                add_alignment(*pair)

    consistent = [t for t in all_pairs
                  if poset.same((t[1], t[2]), (t[3], t[4]))]
    return MultipleAlignment(columns=poset.column_sets(),
                             consistent_pairs=consistent,
                             pairwise_pairs=all_pairs)
