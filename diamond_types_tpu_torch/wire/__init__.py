"""Wire tier: versioned binary framing for all inter-host transport.

Every byte that crosses the mesh — anti-entropy handshakes, proxied
writes, follower-read proxies, cold-hydration snapshot fetches — rides
in one self-describing frame format (`frames.py`), negotiated per
channel with a JSON fallback so old peers keep working mid-rolling-
upgrade (`channel.py`). Far-behind peers and hydration misses receive
one compacted snapshot frame instead of an op replay (`snapshot.py`).

The JAX package's `wire/` with the same exports: `channel.py` is a
byte-identical copy, `frames.py` and `snapshot.py` copies whose docstrings
add a line.
"""

from .frames import (FLAG_LZ4, FRAME_DOCS, FRAME_OPS, FRAME_PATCH,
                     FRAME_SNAPSHOT, FRAME_STATE, FRAME_SUMMARY, MAGIC,
                     WIRE_CHANNELS, WIRE_CTYPE, WIRE_HEADER, WIRE_KEYS,
                     WIRE_VERSION, WireError, decode_docs, decode_frame,
                     decode_ops, decode_state, decode_summary,
                     encode_docs, encode_frame, encode_ops,
                     encode_state, encode_summary, is_frame)
from .channel import WireChannel, wire_enabled
from .snapshot import (SNAPSHOT_OPS_THRESHOLD, apply_snapshot,
                       build_snapshot, should_ship_snapshot)

__all__ = [
    "FLAG_LZ4", "FRAME_DOCS", "FRAME_OPS", "FRAME_PATCH",
    "FRAME_SNAPSHOT", "FRAME_STATE", "FRAME_SUMMARY", "MAGIC",
    "WIRE_CHANNELS", "WIRE_CTYPE", "WIRE_HEADER", "WIRE_KEYS",
    "WIRE_VERSION", "WireError", "decode_docs", "decode_frame",
    "decode_ops", "decode_state", "decode_summary", "encode_docs",
    "encode_frame", "encode_ops", "encode_state", "encode_summary",
    "is_frame", "WireChannel", "wire_enabled",
    "SNAPSHOT_OPS_THRESHOLD", "apply_snapshot", "build_snapshot",
    "should_ship_snapshot",
]
