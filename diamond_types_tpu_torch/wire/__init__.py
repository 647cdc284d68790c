"""The wire tier's codec: versioned binary frames (`frames.py`) and
compacted snapshot frames (`snapshot.py`). Copies of the JAX package's
modules of the same names. The negotiated channel (`wire/channel.py`)
waits for the replication layer.
"""

from .frames import (FLAG_LZ4, FRAME_DOCS, FRAME_OPS, FRAME_PATCH,
                     FRAME_SNAPSHOT, FRAME_STATE, FRAME_SUMMARY, MAGIC,
                     WIRE_CHANNELS, WIRE_CTYPE, WIRE_HEADER, WIRE_KEYS,
                     WIRE_VERSION, WireError, decode_docs, decode_frame,
                     decode_ops, decode_state, decode_summary,
                     encode_docs, encode_frame, encode_ops,
                     encode_state, encode_summary, is_frame)
from .snapshot import (SNAPSHOT_OPS_THRESHOLD, apply_snapshot,
                       build_snapshot, should_ship_snapshot)

__all__ = [
    "FLAG_LZ4", "FRAME_DOCS", "FRAME_OPS", "FRAME_PATCH",
    "FRAME_SNAPSHOT", "FRAME_STATE", "FRAME_SUMMARY", "MAGIC",
    "WIRE_CHANNELS", "WIRE_CTYPE", "WIRE_HEADER", "WIRE_KEYS",
    "WIRE_VERSION", "WireError", "decode_docs", "decode_frame",
    "decode_ops", "decode_state", "decode_summary", "encode_docs",
    "encode_frame", "encode_ops", "encode_state", "encode_summary",
    "is_frame", "SNAPSHOT_OPS_THRESHOLD", "apply_snapshot",
    "build_snapshot", "should_ship_snapshot",
]
