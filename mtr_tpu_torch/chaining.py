"""Interval chaining and record output (chaining.cpp:43-363).

A weighted-interval-scheduling sweep over accepted alignments: events at
start_x and end_x-10 processed in x order; start events link the best
compatible predecessor (largest end_y <= start_y+10); end events insert
into a Pareto list keyed by end_y unless dominated, evicting entries
they dominate.  The chain ending at the largest end_y is printed
root-first.

Reference quirks replicated:
  * an alignment with start_x + 10 == end_x produces two events that
    both satisfy isStart(), so it never enters the Y list
    (chaining.cpp:189-194 vs :255-258);
  * the eviction scan advances past the element following each erased
    entry (iterator erase + loop increment, chaining.cpp:316-328), so
    that element is skipped;
  * events with equal keys keep insertion order (std::multimap), which
    follows the per-read insertion order of the alignment set.
"""

from __future__ import annotations

from mtr_tpu_torch.records import RepeatRecord

MAX_LEN_OVERLAPPING = 10


class _Node:
    __slots__ = ("rec", "start_x", "start_y", "end_x", "end_y", "score", "pred")

    def __init__(self, rec: RepeatRecord):
        self.rec = rec
        self.start_x = rec.rep_start
        self.start_y = rec.rep_start
        self.end_x = rec.rep_end
        self.end_y = rec.rep_end
        self.score = rec.num_matches
        self.pred: "_Node | None" = None

    def set_predecessor(self, a: "_Node") -> None:
        self.pred = a
        self.score += a.score


def chain_records(records: list[RepeatRecord]) -> list[RepeatRecord]:
    """Returns the maximum chain in print order (chaining.cpp:243-345)."""
    if not records:
        return []
    nodes = [_Node(r) for r in records]

    # sorted_by_X: stable sort on key, insertion order = nodes order with
    # the start event inserted before the end event per node
    events: list[tuple[int, _Node]] = []
    for n in nodes:
        if n.start_x + MAX_LEN_OVERLAPPING <= n.end_x:
            events.append((n.start_x, n))
            events.append((n.end_x - MAX_LEN_OVERLAPPING, n))
    events.sort(key=lambda e: e[0])  # Python sort is stable

    # sorted_by_Y emulated as a list of (key=end_y, node) kept sorted by
    # key with insertion order among equal keys
    y_list: list[tuple[int, _Node]] = []

    def y_insert(node: _Node) -> None:
        key = node.end_y
        pos = len(y_list)
        for idx, (k, _) in enumerate(y_list):
            if k > key:
                pos = idx
                break
        y_list.insert(pos, (key, node))

    for key, node in events:
        if key == node.start_x:  # isStart (also true for end events at the same x)
            if y_list:
                # find prev/tmp pair: last entry with end_y <= start_y+10
                thr = node.start_y + MAX_LEN_OVERLAPPING
                prev_idx = 0
                linked = False
                for idx in range(len(y_list)):
                    prev = y_list[prev_idx][1]
                    cur = y_list[idx][1]
                    if prev.end_y <= thr and cur.end_y > thr:
                        node.set_predecessor(prev)
                        linked = True
                        break
                    prev_idx = idx
                if not linked and y_list[prev_idx][1].end_y <= thr:
                    node.set_predecessor(y_list[prev_idx][1])
        else:
            if not y_list:
                y_insert(node)
            else:
                flag = True
                for _, other in y_list:
                    if other.end_y <= node.end_y and other.score > node.score:
                        flag = False
                    if other.end_y > node.end_y:
                        break
                if flag:
                    y_insert(node)
                    # eviction with the iterator-skip quirk
                    idx = 0
                    while idx < len(y_list):
                        other = y_list[idx][1]
                        if other.end_y >= node.end_y and other.score < node.score:
                            del y_list[idx]
                            # erase() returns the next element and the for
                            # loop increments again — skip one entry
                            idx += 1
                        else:
                            idx += 1

    if not y_list:
        return []
    # rbegin() — last entry (largest key; latest inserted among equals)
    tail = y_list[-1][1]
    chain: list[RepeatRecord] = []
    n: _Node | None = tail
    while n is not None:
        chain.append(n.rec)
        n = n.pred
    chain.reverse()
    return chain
