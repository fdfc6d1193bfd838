"""Host-side length-bucketed admission for ragged document groups (the
counterpart of ``repro.ranking.bucketing``).

Device programs want rectangles.  Ragged query groups are padded to the
smallest covering **bucket width** (powers of two by default, the
length-bucketed batching idea from tensor2tensor's data reader), so a
batch flush becomes one grouped device run per bucket shape, and a
streaming ring becomes fixed-width slots a group either fits into or must
skip (``AdmissionQueue``).

Padding lanes point at row 0 (any in-bounds row: scorers must be able
to gather them) and carry ``valid=False``; every downstream consumer —
the group kernel, the executors, the host oracle — masks scores by
validity before they can touch a margin or a verdict.
"""

from __future__ import annotations

from collections import deque

import numpy as np

__all__ = [
    "DEFAULT_BUCKETS",
    "AdmissionQueue",
    "bucket_layout",
    "bucket_widths_for",
    "group_offsets",
    "pack_by_bucket",
]

#: power-of-two pad widths; ``bucket_widths_for`` extends by doubling
#: when a group outgrows the largest one.
DEFAULT_BUCKETS = (4, 8, 16, 32, 64, 128)


def group_offsets(sizes) -> np.ndarray:
    """(G+1,) exclusive prefix sum of group sizes: group ``i`` owns flat
    document rows ``offsets[i]:offsets[i+1]``."""
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.zeros(sizes.size + 1, dtype=np.int64)
    np.cumsum(sizes, out=out[1:])
    return out


def bucket_widths_for(sizes, buckets=DEFAULT_BUCKETS) -> tuple[int, ...]:
    """The subset of bucket widths this batch of group sizes actually
    needs, extending past the ladder by doubling for oversized groups."""
    sizes = np.asarray(sizes, dtype=np.int64)
    ladder = sorted(int(b) for b in buckets)
    if not ladder:
        raise ValueError("bucket ladder must be non-empty")
    top = ladder[-1]
    max_size = int(sizes.max()) if sizes.size else 0
    while top < max_size:
        top *= 2
        ladder.append(top)
    needed = set()
    for sz in sizes:
        for b in ladder:
            if sz <= b:
                needed.add(b)
                break
    return tuple(sorted(needed))


def pack_by_bucket(sizes, buckets=None) -> dict[int, np.ndarray]:
    """Partition group indices by covering bucket width.

    Returns ``{bucket_width: group_index_array}`` with every group
    assigned to the smallest width that holds it; arrays keep the
    original arrival order so verdicts can be scattered back.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    widths = bucket_widths_for(sizes, buckets if buckets is not None else DEFAULT_BUCKETS)
    out: dict[int, list[int]] = {b: [] for b in widths}
    for gi, sz in enumerate(sizes):
        for b in widths:
            if sz <= b:
                out[b].append(gi)
                break
    return {b: np.asarray(idx, dtype=np.int64) for b, idx in out.items() if idx}


def bucket_layout(
    sizes, bucket: int, offsets=None
) -> tuple[np.ndarray, np.ndarray]:
    """Rectangular (G, bucket) row-id layout for groups padded to one
    bucket width.

    ``rows[i, j]`` is the flat document row of lane ``j`` of group ``i``
    (``offsets[i] + j``), with padding lanes parked on row 0 and marked
    invalid.  Returns ``(rows int32, valid bool)``.
    """
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.size and int(sizes.max()) > bucket:
        raise ValueError(
            f"group of size {int(sizes.max())} does not fit bucket {bucket}"
        )
    off = group_offsets(sizes) if offsets is None else np.asarray(offsets)
    G = sizes.size
    lane = np.arange(bucket, dtype=np.int64)[None, :]
    valid = lane < sizes[:, None]
    rows = np.where(valid, off[:G, None] + lane, 0).astype(np.int32)
    return rows, valid


class AdmissionQueue:
    """FIFO of pending groups feeding fixed-width ring slots.

    When a slot of width ``B`` frees, the head group may not fit
    (``size > B``).  Two policies: ``"skip-ahead"`` admits the FIRST
    pending group that fits (occupancy over admission order); ``"wait"``
    keeps strict arrival order and leaves the slot idle until the head
    fits elsewhere.
    """

    def __init__(self, policy: str = "skip-ahead"):
        if policy not in ("skip-ahead", "wait"):
            raise ValueError(f"unknown admission policy {policy!r}")
        self.policy = policy
        self._pending: deque[tuple[int, int]] = deque()

    def push(self, gid: int, size: int) -> None:
        if size < 1:
            raise ValueError("group size must be >= 1")
        self._pending.append((int(gid), int(size)))

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> list[tuple[int, int]]:
        return list(self._pending)

    def pop_for(self, width: int) -> int | None:
        """Admit one group into a freed slot of ``width`` lanes, or
        ``None`` if the policy leaves the slot empty this round."""
        if not self._pending:
            return None
        if self.policy == "wait":
            gid, size = self._pending[0]
            if size <= width:
                self._pending.popleft()
                return gid
            return None
        for i, (gid, size) in enumerate(self._pending):
            if size <= width:
                del self._pending[i]
                return gid
        return None
