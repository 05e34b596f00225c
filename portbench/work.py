"""The least time the card could take for the work of a run, from shapes.

Per call the work is counted as the algorithm needs it, whatever kernel
does it: each input row the product needs read once (the k data rows of
an encode, the k survivor rows of a decode, never the whole arrival
layout), each output row written once, and one multiply-add per output
byte per input row.  The bound is the larger of bytes over the card's
memory bandwidth and operations over its int8 rate (`peaks.json`).
"""
from __future__ import annotations

import json
from dataclasses import dataclass

from .spec import HERE


@dataclass(frozen=True)
class Work:
    bytes: int
    ops: int

    def __mul__(self, calls: int) -> "Work":
        return Work(self.bytes * calls, self.ops * calls)


def gf_product(stripes: int, rows_in: int, rows_out: int,
               chunk: int) -> Work:
    """An (rows_out x rows_in) GF(2^8) product over `stripes` stripes of
    `chunk`-byte rows."""
    return Work(bytes=stripes * chunk * (rows_in + rows_out),
                ops=stripes * chunk * rows_out * rows_in)


def peaks(kind: str) -> dict:
    table = json.loads((HERE / "peaks.json").read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in peaks.json "
                       f"(have {sorted(table)})")
    return table[kind]


def bound_s(work: Work, kind: str) -> tuple[float, str]:
    """(seconds, what bounds it) for `work` on the card `kind`."""
    p = peaks(kind)
    by_bytes = work.bytes / p["hbm_bytes_per_s"]
    by_ops = work.ops / p["int8_ops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")
