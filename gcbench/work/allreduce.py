"""The all-reduces of a data-parallel step in the profiled pass, which
every rank takes: the device intervals of the NCCL kernels, the part of
them during which no other kernel, copy or fill ran on the same card,
and the bus bandwidth of a ring all-reduce (each rank sends and receives
2 (n - 1) / n of the buffer).

A collective's kernel starts when its rank reaches it and ends when the
exchange does, so on every rank but the last to arrive it also holds the
wait for the others.  The shortest of a collective's kernels over the
ranks is about its transfer; the longest less the shortest is the ranks'
skew.  Every rank runs the same collectives in the same order, so the
k-th NCCL kernel of one rank's pass is the k-th of every other's."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

NCCL = "nccl"


def _union(ivs) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def is_collective(name: str) -> bool:
    return NCCL in name.lower()


def collectives(profile) -> List[int]:
    """Device ns of each NCCL kernel of ``profile``, in start order."""
    return [e - s for n, s, e in sorted(profile.device, key=lambda d: d[1])
            if is_collective(n)]


def spans(profiles: Sequence) -> Optional[List[Tuple[int, int]]]:
    """(shortest, longest) device ns over the ranks' ``profiles`` of each
    collective; None where there is none, or where the ranks' passes hold
    different numbers of them."""
    rows = [collectives(p) for p in profiles]
    if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
        return None
    return [(min(c), max(c)) for c in zip(*rows)]


def transfer_ns(profiles: Sequence) -> Optional[int]:
    """The collectives' device ns without the wait: each one's shortest
    kernel over the ranks, summed."""
    sp = spans(profiles)
    return None if sp is None else sum(lo for lo, _ in sp)


def skew_ns(profiles: Sequence) -> Optional[int]:
    """The ranks' skew at the collectives: each one's longest kernel less
    its shortest, summed."""
    sp = spans(profiles)
    return None if sp is None else sum(hi - lo for lo, hi in sp)


def exposed_ns(profile) -> int:
    """Device ns of the NCCL kernels' union that no other device
    activity of the same pass covers."""
    coll = _union((s, e) for n, s, e in profile.device if is_collective(n))
    other = _union((s, e) for n, s, e in profile.device
                   if not is_collective(n))
    covered, j = 0, 0
    for s, e in coll:
        while j < len(other) and other[j][1] <= s:
            j += 1
        k = j
        while k < len(other) and other[k][0] < e:
            covered += min(e, other[k][1]) - max(s, other[k][0])
            k += 1
    return sum(e - s for s, e in coll) - covered


def bus_bytes(nbytes: int, world: int) -> float:
    """The bytes each rank moves over its links in a ring all-reduce of
    ``nbytes``."""
    return 2.0 * (world - 1) / world * nbytes
