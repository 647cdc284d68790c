"""Editing-trace loader.

The JAX package's `text/trace.py` `TestData` and `load_trace`, copied: the
concurrent-editing-trace JSON format of the reference's bench corpus
(gzipped JSON with `startContent`, `endContent` and
`txns: [{patches: [[pos, del, ins], ...]}]`), which the serve-bench driver
replays.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class TestData:
    start_content: str
    end_content: str
    txns: List[List[Tuple[int, int, str]]]  # per txn: [(pos, num_deleted, ins)]


def load_trace(path: str) -> TestData:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf8") as f:
        d = json.load(f)
    return TestData(
        start_content=d["startContent"],
        end_content=d["endContent"],
        txns=[[(p[0], p[1], p[2]) for p in t["patches"]] for t in d["txns"]],
    )
