"""Decision-tree building from single-Gaussian statistics.

Counterpart of old_kaldi_git_tpu/tree/build_tree.py (reference
src/tree/{build-tree.h,build-tree-utils.h,cluster-utils.h,
clusterable-classes.h}): GaussClusterable sufficient stats, tree stats from
alignments, questions by agglomerative phone clustering, and greedy
likelihood-gain splitting with max-leaves / min-gain stopping, one root per
central phone, and the tree-stats file I/O and `cluster_leaves` of the
command-line tools (acc-tree-stats, sum-tree-stats, build-tree-two-level).

Host numpy, like the JAX package's, and built to give its tree on the same
stats: the same split at every node, the same pdf numbering.  The JAX
package scores every question of a leaf by adding the leaf's event stats
one by one into a "yes" and a "no" GaussClusterable; here all the
candidate splits of a leaf are summed at once, as masked sums along the
events (`_masked_sums`), which numpy adds in the same order, event by
event, so every sum, objective and gain is the JAX package's to the bit.
A question that puts the leaf's events into the same "yes" and "no" sets
as an earlier question gets the same gain, and the first of equal gains
wins, so only the first question of each partition is scored.  Tree
statistics are accumulated by `np.add.at`, which adds frame by frame in
order, as the JAX package's per-frame loop does.  `cluster_leaves` merges
as the JAX package's does, the pair of least loss first (the first in
row-major order of equal losses), but keeps each pair's loss from one
merge to the next and computes anew only the pairs of the merged cluster:
the same operations on the same stats, so every loss is the JAX package's
to the bit.
"""

from __future__ import annotations

import heapq
import math
import zlib
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from old_kaldi_git_tpu_torch.hmm.hmm_utils import phone_starts
from old_kaldi_git_tpu_torch.tree.context_dep import ContextDependency
from old_kaldi_git_tpu_torch.tree.event_map import (
    KEY_PDF_CLASS,
    ConstantEventMap,
    EventMap,
    SplitEventMap,
    TableEventMap,
    make_event,
)
from old_kaldi_git_tpu_torch.utils.log import KaldiError, get_logger

log = get_logger("tree")

MASKED_SUM_FLOATS = 1 << 22  # floats of one masked-sum block (32 MB)
LOG_2PI_PLUS_1 = math.log(2 * math.pi) + 1.0


class GaussClusterable:
    """Diagonal-Gaussian sufficient statistics (count, Σx, Σx²) with the
    single-Gaussian data log-likelihood as the clustering objective."""

    __slots__ = ("count", "x", "x2")

    def __init__(self, dim: int = 0):
        self.count = 0.0
        self.x = np.zeros(dim)
        self.x2 = np.zeros(dim)

    def add(self, other: "GaussClusterable") -> None:
        if self.x.size == 0 and other.x.size:
            self.x = np.zeros_like(other.x)
            self.x2 = np.zeros_like(other.x2)
        self.count += other.count
        if other.x.size:
            self.x += other.x
            self.x2 += other.x2

    def copy(self) -> "GaussClusterable":
        out = GaussClusterable()
        out.count = self.count
        out.x = self.x.copy()
        out.x2 = self.x2.copy()
        return out

    def objf(self, var_floor: float = 0.01) -> float:
        """Data log-likelihood under the ML diagonal Gaussian."""
        if self.count <= 0:
            return 0.0
        mean = self.x / self.count
        var = np.maximum(self.x2 / self.count - mean ** 2, var_floor)
        dim = self.x.size
        return float(-0.5 * self.count * (dim * LOG_2PI_PLUS_1 + np.log(var).sum()))


def merged_objf(a: GaussClusterable, b: GaussClusterable) -> float:
    m = a.copy()
    m.add(b)
    return m.objf()


def _objf_rows(sums: np.ndarray, dim: int, var_floor: float = 0.01) -> np.ndarray:
    """GaussClusterable.objf of each row [count, Σx, Σx²] of `sums`, the
    same operations in the same order."""
    c = sums[:, 0]
    mean = sums[:, 1: 1 + dim] / c[:, None]
    var = np.maximum(sums[:, 1 + dim:] / c[:, None] - mean ** 2, var_floor)
    return -0.5 * c * (dim * LOG_2PI_PLUS_1 + np.log(var).sum(axis=1))


def _masked_sums(mask: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """[S, n] bool × [n, F] → [S, F]: for each mask row, the sum of the
    selected rows, added in row order (a sum over the middle axis of a
    C-contiguous [S, n, F] array runs row after row).  Masked-out rows add
    a zero, which leaves every partial sum as it was."""
    S, n = mask.shape
    out = np.empty((S, rows.shape[1]))
    step = max(1, MASKED_SUM_FLOATS // max(1, n * rows.shape[1]))
    for a in range(0, S, step):
        out[a: a + step] = (mask[a: a + step, :, None] * rows[None]).sum(axis=1)
    return out


def _to_clusterable(row: np.ndarray, dim: int) -> GaussClusterable:
    g = GaussClusterable()
    g.count = float(row[0])
    g.x = row[1: 1 + dim].copy()
    g.x2 = row[1 + dim:].copy()
    return g


# ---------------------------------------------------------------------------
# stats accumulation (reference src/hmm/tree-accu.cc AccumulateTreeStats)
# ---------------------------------------------------------------------------

def accumulate_tree_stats(
    alignment: Sequence[int],
    feats: np.ndarray,
    transition_model,
    N: int = 3,
    P: int = 1,
    stats: Optional[Dict[tuple, GaussClusterable]] = None,
) -> Dict[tuple, GaussClusterable]:
    """alignment: per-frame transition-ids; feats [T, D].  Returns/updates
    {event → GaussClusterable}, the event holding the phone window of the
    frame's phone (0 beyond the utterance) and its pdf-class; new events
    enter the dict in the order of their first frame."""
    stats = stats if stats is not None else {}
    ali = np.asarray(alignment, np.int64)
    feats = np.asarray(feats)
    if len(ali) != len(feats):
        raise KaldiError(f"alignment length {len(ali)} != num frames {len(feats)}")
    if not len(ali):
        return stats
    arr = transition_model.tid_arrays()
    starts = phone_starts(transition_model, ali)
    seg = np.cumsum(starts) - 1
    phone_seq = np.concatenate([np.zeros(P, np.int64), arr["phone"][ali[starts]],
                                np.zeros(N - 1 - P, np.int64)])
    # per frame: pdf-class, then the window's phones
    cols = [arr["pdf_class"][ali]] + [phone_seq[seg + j] for j in range(N)]
    codes = np.stack(cols, axis=1)
    uniq, first, inverse = np.unique(codes, axis=0, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first, kind="stable")
    dim = feats.shape[1]
    acc = np.zeros((len(uniq), 1 + 2 * dim))
    events = []
    for r, u in enumerate(order):
        pc, window = int(uniq[u, 0]), uniq[u, 1:].tolist()
        event = make_event([(KEY_PDF_CLASS, pc)] + list(enumerate(window)))
        events.append(event)
        if event in stats:
            st = stats[event]
            acc[r] = np.concatenate([[st.count], st.x, st.x2])
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    ev = rank[inverse.reshape(-1)]
    # the frame's weight is 1.0: its Σx² term is feat·feat in the features'
    # type, as the JAX package's GaussClusterable.add_sample forms it
    np.add.at(acc[:, 0], ev, 1.0)
    np.add.at(acc[:, 1: 1 + dim], ev, feats.astype(np.float64))
    np.add.at(acc[:, 1 + dim:], ev, (feats * feats).astype(np.float64))
    for r, event in enumerate(events):
        new = _to_clusterable(acc[r], dim)
        if event in stats:
            st = stats[event]
            st.count, st.x, st.x2 = new.count, new.x, new.x2
        else:
            stats[event] = new
    return stats


# ---------------------------------------------------------------------------
# question generation (reference bin/cluster-phones + compile-questions)
# ---------------------------------------------------------------------------

def cluster_phones_into_questions(
    stats: Dict[tuple, GaussClusterable],
    phones: Sequence[int],
    P: int = 1,
    extra_questions: Sequence[Set[int]] = (),
) -> List[Set[int]]:
    """Agglomerative clustering of central-phone stats; every intermediate
    cluster becomes a question (set of phones)."""
    per_phone: Dict[int, GaussClusterable] = {p: GaussClusterable() for p in phones}
    for event, st in stats.items():
        phone = dict(event).get(P)
        if phone in per_phone:
            per_phone[phone].add(st)
    active: List[Tuple[Set[int], GaussClusterable]] = [
        ({p}, per_phone[p]) for p in phones if per_phone[p].count > 0]
    questions: List[Set[int]] = [set(s) for s, _ in active]
    while len(active) > 1:
        best = None
        for i in range(len(active)):
            for j in range(i + 1, len(active)):
                gain = (merged_objf(active[i][1], active[j][1])
                        - active[i][1].objf() - active[j][1].objf())
                if best is None or gain > best[0]:
                    best = (gain, i, j)
        _, i, j = best
        merged_set = active[i][0] | active[j][0]
        merged_stats = active[i][1].copy()
        merged_stats.add(active[j][1])
        active = [a for k, a in enumerate(active) if k not in (i, j)]
        active.append((merged_set, merged_stats))
        questions.append(set(merged_set))
    for q in extra_questions:
        questions.append(set(q))
    seen, out = set(), []
    for q in questions:
        key = frozenset(q)
        if key not in seen and q:
            seen.add(key)
            out.append(q)
    return out


# ---------------------------------------------------------------------------
# greedy tree building (reference src/tree/build-tree.cc BuildTree)
# ---------------------------------------------------------------------------

class _Table:
    """Every event's stats as one row [count, Σx, Σx²] (`sums`, [E, 1+2D]),
    and its value under each key (`values`, [E, K], −1 where absent), in
    the stats dict's order."""

    def __init__(self, stats: Dict[tuple, GaussClusterable], keys: Sequence[int]):
        self.events = list(stats)
        self.dim = next(iter(stats.values())).x.size
        self.sums = np.stack([np.concatenate([[st.count], st.x, st.x2])
                              for st in stats.values()])
        self.key_col = {k: c for c, k in enumerate(keys)}
        self.values = np.asarray([[dict(e).get(k, -1) for k in keys] for e in self.events],
                                 np.int64).reshape(len(self.events), len(keys))


def _membership(questions: Sequence[Set[int]], max_value: int) -> np.ndarray:
    """[Q, max_value + 2] bool: question q holds value v (the last column,
    value −1, stands for an absent key and is in no question)."""
    m = np.zeros((len(questions), max_value + 2), bool)
    for i, q in enumerate(questions):
        m[i, [v for v in q if 0 <= v <= max_value]] = True
    return m


def _best_split(table: _Table, items: np.ndarray, total: GaussClusterable,
                keys: Sequence[int], questions_per_key: Dict[int, List[Set[int]]],
                membership: Dict[int, np.ndarray]):
    """Best (gain, key, question) split of the leaf holding events `items`
    (in order), or None: the first of the largest gains over the keys and
    questions in order, as the JAX package scans them."""
    base = total.objf()
    rows = table.sums[items]
    cands: List[Tuple[int, int]] = []  # (key, question index)
    masks = []
    for key in keys:
        qs = questions_per_key.get(key, ())
        if not qs:
            continue
        vals = table.values[items, table.key_col[key]]
        present, inv = np.unique(vals, return_inverse=True)
        by_value = membership[key][:, present]  # [Q, distinct values]
        _, first = np.unique(by_value, axis=0, return_index=True)
        for qi in np.sort(first):
            row = by_value[qi]
            if row.any() and not row.all():
                cands.append((key, int(qi)))
                masks.append(row[inv.reshape(-1)])
    if not cands:
        return None
    yes = np.stack(masks)
    dim = table.dim
    gains = ((_objf_rows(_masked_sums(yes, rows), dim)
              + _objf_rows(_masked_sums(~yes, rows), dim)) - base)
    best = int(np.argmax(gains))
    key, qi = cands[best]
    return float(gains[best]), key, questions_per_key[key][qi]


def build_tree(
    stats: Dict[tuple, GaussClusterable],
    phones: Sequence[int],
    num_pdf_classes: Dict[int, int],
    N: int = 3,
    P: int = 1,
    questions: Optional[List[Set[int]]] = None,
    max_leaves: int = 1000,
    thresh: float = 300.0,
) -> ContextDependency:
    """Greedy likelihood-gain splitting, one root per central phone: the
    split with the largest gain over all leaves goes first (heap order,
    ties by leaf age), until `max_leaves` or no gain above `thresh`.
    Leaves are numbered depth-first, "yes" before "no", roots in phone
    order; a phone without stats gets a pdf per pdf-class after them."""
    if questions is None:
        questions = cluster_phones_into_questions(stats, phones, P)
    max_pc = max(num_pdf_classes.values())
    questions_per_key: Dict[int, List[Set[int]]] = {
        pos: questions for pos in range(N) if pos != P}
    questions_per_key[KEY_PDF_CLASS] = [set(range(k + 1)) for k in range(max_pc - 1)] or [{0}]
    keys = [KEY_PDF_CLASS] + [pos for pos in range(N) if pos != P]

    table = _Table(stats, [KEY_PDF_CLASS] + list(range(N)))
    max_value = int(max(table.values.max(), max(max(q) for q in questions if q)))
    membership = {k: _membership(qs, max_value) for k, qs in questions_per_key.items()}

    # roots: central phone; totals summed event by event in the dict's order
    root_items: Dict[int, List[int]] = {}
    root_total: Dict[int, GaussClusterable] = {}
    for i, st in enumerate(stats.values()):
        phone = int(table.values[i, table.key_col[P]])
        if phone not in root_items:
            root_items[phone] = []
            root_total[phone] = GaussClusterable()
        root_items[phone].append(i)
        root_total[phone].add(st)
    missing = [p for p in phones if p not in root_items]
    if missing:
        log.warning("no tree stats for phones %s (unseen in data)", missing)

    # a pool of leaves, each with its best split; a heap of candidate splits
    heap: List[Tuple[float, int]] = []  # (-gain, pool index)
    pool: List[Tuple[np.ndarray, Optional[tuple]]] = []  # (items, split)
    nodes: List[dict] = []
    root_nodes: Dict[int, dict] = {}

    def add_leaf(items: np.ndarray, total: GaussClusterable) -> dict:
        split = _best_split(table, items, total, keys, questions_per_key, membership)
        idx = len(pool)
        pool.append((items, split))
        node: dict = {}
        nodes.append(node)
        if split is not None and split[0] > thresh:
            heapq.heappush(heap, (-split[0], idx))
        return node

    for phone in sorted(root_items):
        root_nodes[phone] = add_leaf(np.asarray(root_items[phone], np.int64),
                                     root_total[phone])
    num_leaves = len(root_items)

    while heap and num_leaves < max_leaves:
        _, idx = heapq.heappop(heap)
        items, (gain, key, q) = pool[idx]
        if gain <= thresh:
            continue
        yes = np.isin(table.values[items, table.key_col[key]], list(q))
        halves = np.stack([yes, ~yes])
        totals = _masked_sums(halves, table.sums[items])
        node = nodes[idx]
        node["split"] = (key, frozenset(q))
        node["yes"] = add_leaf(items[yes], _to_clusterable(totals[0], table.dim))
        node["no"] = add_leaf(items[~yes], _to_clusterable(totals[1], table.dim))
        num_leaves += 1

    counter = [0]

    def to_event_map(node: dict) -> EventMap:
        if "split" in node:
            key, q = node["split"]
            return SplitEventMap(key, q, to_event_map(node["yes"]), to_event_map(node["no"]))
        pdf = counter[0]
        counter[0] += 1
        return ConstantEventMap(pdf)

    table_map: Dict[int, EventMap] = {}
    for phone in sorted(root_items):
        table_map[phone] = to_event_map(root_nodes[phone])
    # phones never seen: a fresh pdf per pdf-class, so that decoding graphs
    # can still be built
    for phone in sorted(missing):
        sub = {}
        for pc in range(num_pdf_classes[phone]):
            sub[pc] = ConstantEventMap(counter[0])
            counter[0] += 1
        table_map[phone] = TableEventMap(KEY_PDF_CLASS, sub)
    log.info("build_tree: %d leaves (max %d)", counter[0], max_leaves)
    return ContextDependency(N, P, TableEventMap(P, table_map))


def leaf_digests(ctx_dep: ContextDependency, stats: Dict[tuple, GaussClusterable]) -> List[str]:
    """A tree's leaves by the events they hold: per leaf, the CRC-32 (8 hex
    digits) of the indices, in the stats dict's order, of the events the
    tree sends there; sorted.  Two trees on stats with the same events in
    the same order (which the alignments alone fix) hold the same events in
    a leaf where their digests agree."""
    by_leaf: Dict[int, List[int]] = {}
    for i, event in enumerate(stats):
        by_leaf.setdefault(ctx_dep.root.map(event), []).append(i)
    return sorted(f"{zlib.crc32(np.asarray(v, '<i4').tobytes()):08x}"
                  for v in by_leaf.values())


# ---------------------------------------------------------------------------
# tree-stats files (reference bin/acc-tree-stats writes BuildTreeStatsType;
# bin/sum-tree-stats adds; bin/build-tree reads).  The JAX package's layout:
# "<TreeStats>", the number of events, then per event in sorted order its
# (key, value) pairs as int32s, the count as a double and Σx, Σx² as float64
# vectors, "</TreeStats>".
# ---------------------------------------------------------------------------

def write_tree_stats(f, stats: Dict[tuple, GaussClusterable]) -> None:
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    iof.init_kaldi_output_stream(f, True)
    iof.write_token(f, "<TreeStats>")
    iof.write_int32(f, len(stats))
    for event, gc in sorted(stats.items()):
        iof.write_int32(f, len(event))
        for k, v in event:
            iof.write_int32(f, int(k))
            iof.write_int32(f, int(v))
        iof.write_double(f, gc.count)
        iof.write_vector(f, gc.x, dtype=np.float64)
        iof.write_vector(f, gc.x2, dtype=np.float64)
    iof.write_token(f, "</TreeStats>")


def read_tree_stats(f) -> Dict[tuple, GaussClusterable]:
    """{event → GaussClusterable} in the file's (sorted) order."""
    from old_kaldi_git_tpu_torch.utils import io_funcs as iof

    if not iof.init_kaldi_input_stream(f):
        raise KaldiError("tree-stats file must be binary")
    iof.expect_token(f, "<TreeStats>")
    stats: Dict[tuple, GaussClusterable] = {}
    for _ in range(iof.read_int32(f)):
        ne = iof.read_int32(f)
        event = tuple((iof.read_int32(f), iof.read_int32(f)) for _ in range(ne))
        gc = GaussClusterable()
        gc.count = iof.read_float(f)
        gc.x = np.asarray(iof.read_vector(f), np.float64)
        gc.x2 = np.asarray(iof.read_vector(f), np.float64)
        stats[event] = gc
    iof.expect_token(f, "</TreeStats>")
    return stats


def sum_tree_stats(dsts: Dict[tuple, GaussClusterable],
                   src: Dict[tuple, GaussClusterable]) -> Dict[tuple, GaussClusterable]:
    """Adds src's stats into dsts (a copy for a new event); returns dsts."""
    for event, gc in src.items():
        if event in dsts:
            dsts[event].add(gc)
        else:
            dsts[event] = gc.copy()
    return dsts


def cluster_leaves(stats: Dict[tuple, GaussClusterable], ctx_dep,
                   num_clusters: int) -> List[int]:
    """Bottom-up clustering of a tree's leaves into `num_clusters` groups by
    likelihood loss (reference build-tree-two-level / ClusterBottomUp): the
    leaf → cluster mapping, clusters numbered 0..K-1 in the order of their
    smallest leaf; a leaf without stats goes to cluster 0."""
    num_pdfs = ctx_dep.num_pdfs
    pooled: List[Optional[GaussClusterable]] = [None] * num_pdfs
    for event, st in stats.items():
        leaf = ctx_dep.root.map(event)
        if leaf is None:
            continue
        if pooled[leaf] is None:
            pooled[leaf] = st.copy()
        else:
            pooled[leaf].add(st)
    live = {i: pooled[i] for i in range(num_pdfs) if pooled[i] is not None}
    members: Dict[int, List[int]] = {i: [i] for i in live}
    objf = {i: g.objf() for i, g in live.items()}
    # loss[a, b] for live a < b (inf elsewhere): row-major argmin is the
    # first pair of least loss in the JAX package's scan order
    loss = np.full((num_pdfs, num_pdfs), np.inf)

    def pair(a: int, b: int) -> None:
        loss[a, b] = objf[a] + objf[b] - merged_objf(live[a], live[b])

    keys = sorted(live)
    for ai, a in enumerate(keys):
        for b in keys[ai + 1:]:
            pair(a, b)
    while len(live) > max(1, num_clusters):
        a, b = divmod(int(np.argmin(loss)), num_pdfs)
        live[a].add(live.pop(b))
        members[a].extend(members.pop(b))
        objf[a] = live[a].objf()
        loss[b, :] = loss[:, b] = np.inf
        for k in live:
            if k < a:
                pair(k, a)
            elif k > a:
                pair(a, k)
    mapping = [0] * num_pdfs
    for cluster, (_, leaves) in enumerate(sorted(members.items())):
        for leaf in leaves:
            mapping[leaf] = cluster
    return mapping
