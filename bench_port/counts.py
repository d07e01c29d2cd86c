"""The yardstick's arithmetic: the bytes a kernel's problem needs, and the
card's peaks.

A roofline bound here is the problem's own inputs read once and its
outputs written once, counted over valid points only, over the card's
memory bandwidth.  Padding, tiles, sorted copies, payload layouts and how
many (query, point) pairs an implementation sweeps are not counted, so the
bound reads the same work whatever implements it, and no implementation
can read above 100 %.  Float32 throughout: 4 bytes a value.
"""

from __future__ import annotations

import json
from pathlib import Path

F32 = 4


def nn_bytes(queries: int, db_points: int, dim: int, payload: int) -> int:
    """A nearest-neighbour search with a payload: the queries' coordinates
    and the db's coordinates and payload in; per query its squared
    distance, its index and the winner's payload out."""
    return F32 * (queries * dim + db_points * (dim + payload)
                  + queries * (2 + payload))


def icp2d_pairs_bytes(src_points: int, dst_points: int, pairs: int) -> int:
    """Whole 2D ICP calls on pairs: both clouds' xy and each pair's warm
    start (rotation and translation, 6 values) in; each pair's transform
    and iteration counts (8 values) out."""
    return F32 * (2 * (src_points + dst_points) + pairs * (6 + 8))


def peaks(device_name: str):
    """The card's published peaks (``peaks.json``), or None for a card the
    table does not hold."""
    table = json.loads((Path(__file__).resolve().parent / "peaks.json")
                       .read_text())
    return table.get(device_name)
