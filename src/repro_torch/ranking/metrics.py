"""Ranking quality metrics (the counterpart of ``repro.ranking.metrics``).

Only what the bench needs: NDCG@k over ragged groups, computed from
relevance labels and the ranked verdict ids the grouped paths emit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ndcg_at_k"]


def ndcg_at_k(relevance, verdicts, sizes, k: int) -> float:
    """Mean NDCG@k over query groups.

    ``relevance`` is the flat (N,) graded relevance per document (same
    row order as the score matrix), ``verdicts`` (G, k) the GLOBAL
    document ids in rank order (-1 padded) as returned by the grouped
    paths, ``sizes`` (G,) the ragged group sizes.  Gains are the
    standard ``2^rel - 1`` with ``log2`` discounts; groups whose ideal
    DCG is zero (all-irrelevant) contribute NDCG 1.0 — any order of
    nothing is perfect.
    """
    rel = np.asarray(relevance, dtype=np.float64)
    verdicts = np.asarray(verdicts)
    sizes = np.asarray(sizes, dtype=np.int64)
    G = sizes.size
    if G == 0:
        return 1.0
    discounts = 1.0 / np.log2(np.arange(2, k + 2))
    off = 0
    total = 0.0
    for i in range(G):
        sz = int(sizes[i])
        grp_rel = rel[off : off + sz]
        off += sz
        picked = verdicts[i][verdicts[i] >= 0]
        gains = np.power(2.0, rel[picked]) - 1.0
        dcg = float((gains * discounts[: picked.size]).sum())
        ideal = np.sort(grp_rel)[::-1][:k]
        igains = np.power(2.0, ideal) - 1.0
        idcg = float((igains * discounts[: ideal.size]).sum())
        total += 1.0 if idcg == 0.0 else dcg / idcg
    return total / G
