"""The port's wire channel (`wire/channel.py`) against the JAX package's.

`tests/test_wire.py`'s channel cases run through both packages: peer
negotiation and the JSON fallback, the `DT_WIRE_DISABLED` kill switch,
per-channel accounting into `ReplicationMetrics`, and the frontier-keyed
frame cache. Each case returns what it observed, and the two packages'
observations must be equal; the port's are also pinned to the values the
JAX test pins. `wire/channel.py` is a byte-identical copy, and the port's
`wire` package exports JAX's names.
"""

import importlib
from pathlib import Path

import pytest

pytestmark = pytest.mark.wire

REPO = Path(__file__).resolve().parent.parent
ROOTS = ("diamond_types_tpu", "diamond_types_tpu_torch")


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _both(scenario, *args):
    """Run `scenario(root, *args)` for both packages; return the port's
    observations after holding them equal to JAX's."""
    jax_obs, port_obs = (scenario(root, *args) for root in ROOTS)
    assert port_obs == jax_obs
    return port_obs


def test_channel_is_a_byte_identical_copy():
    rel = "wire/channel.py"
    assert (REPO / "diamond_types_tpu_torch" / rel).read_bytes() == \
        (REPO / "diamond_types_tpu" / rel).read_bytes()


def test_wire_package_exports_match():
    jw, tw = (_mod(r, "wire") for r in ROOTS)
    assert tw.__all__ == jw.__all__
    assert tw.WireChannel.__module__ == "diamond_types_tpu_torch.wire.channel"
    for name in jw.__all__:
        assert hasattr(tw, name), name


def _negotiation(root):
    WireChannel = _mod(root, "wire.channel").WireChannel
    ch = WireChannel(enabled=True)
    out = [ch.header_value(), ch.use_wire("peer")]
    ch.note_peer("peer", 1)
    out.append(ch.use_wire("peer"))
    ch.note_peer("old", None)
    out.append(ch.use_wire("old"))
    ch.note_peer("weird", "bogus")
    out.append(ch.use_wire("weird"))
    off = WireChannel(enabled=False)
    off.note_peer("peer", 1)
    out += [off.header_value(), off.use_wire("peer")]
    return out


def test_channel_negotiation_and_fallback():
    assert _both(_negotiation) == ["v1", False, True, False, False, None,
                                   False]


def _kill_switch(root, monkeypatch):
    ch = _mod(root, "wire.channel")
    out = []
    monkeypatch.setenv("DT_WIRE_DISABLED", "1")
    out += [ch.wire_enabled(), ch.WireChannel().enabled]
    monkeypatch.setenv("DT_WIRE_DISABLED", "0")
    out.append(ch.wire_enabled())
    monkeypatch.delenv("DT_WIRE_DISABLED")
    out += [ch.wire_enabled(), ch.WireChannel().enabled]
    return out


def test_wire_enabled_env_kill_switch(monkeypatch):
    assert _both(_kill_switch, monkeypatch) == [False, False, True, True,
                                                True]


def _accounting(root):
    m = _mod(root, "replicate.metrics").ReplicationMetrics()
    frames = _mod(root, "wire.frames")
    ch = _mod(root, "wire.channel").WireChannel(metrics=m, enabled=True)
    ch.account("proxy", sent_bytes=10, json_bytes=30, framed=True)
    ch.account("proxy", sent_bytes=50)
    ch.account("hydrate", sent_bytes=5, framed=True, snapshot=True)
    ch.account("antientropy", sent_bytes=40, json_bytes=40, framed=True)
    w = m.wire_counters()
    keys = {f"{c}_{k}" for c in frames.WIRE_CHANNELS for k in frames.WIRE_KEYS}
    return {"wire": w, "keys_complete": set(w) == keys,
            "snapshot_wire": m.snapshot()["wire"],
            "bare": _mod(root, "wire.channel").WireChannel().counters()}


def test_channel_accounting_lands_in_metrics():
    got = _both(_accounting)
    w = got["wire"]
    assert (w["proxy_bytes_sent"], w["proxy_bytes_saved"],
            w["proxy_frames"]) == (60, 20, 1)
    assert (w["hydrate_frames"], w["hydrate_snapshot_ships"]) == (1, 1)
    assert w["antientropy_bytes_saved"] == 0
    assert got["keys_complete"]
    assert got["snapshot_wire"]["gossip_bytes_sent"] == 0
    assert got["bare"]["proxy_frames"] == 0


def _frame_cache(root):
    ch = _mod(root, "wire.channel").WireChannel(enabled=True,
                                                 cache_entries=2)
    builds = []

    def builder(tag):
        def build():
            builds.append(tag)
            return f"frame:{tag}".encode("utf8")
        return build

    key = (("alice", 3),)
    out = [ch.cached_snapshot("d1", key, builder("a")),
           ch.cached_snapshot("d1", key, builder("a2"))]
    ch.invalidate("d1")
    out.append(ch.cached_snapshot("d1", key, builder("a3")))
    for doc, tag in (("d2", "b"), ("d3", "c"), ("d1", "a4")):
        out.append(ch.cached_snapshot(doc, key, builder(tag)))
    return {"frames": out, "builds": builds}


def test_frame_cache_reuse_invalidate_evict():
    got = _both(_frame_cache)
    assert got["frames"][:3] == [b"frame:a", b"frame:a", b"frame:a3"]
    assert got["builds"] == ["a", "a3", "b", "c", "a4"]


def test_frames_built_by_one_package_apply_in_the_other():
    """An OPS frame and a compacted snapshot frame cross the packages
    both ways: each decodes to the same ops, and each snapshot applied to
    an empty oplog of the other package gives the sender's text and
    version."""
    from torch_parity import TwinDocs
    jol = _mod(ROOTS[0], "text.oplog").OpLog()
    tol = _mod(ROOTS[1], "text.oplog").OpLog()
    twins = TwinDocs([jol, tol], seed=41, alphabet="ab中😀é ")
    twins.type_base("alice", 40)
    twins.fork(["alice", "bob"])
    twins.edits("alice", 12)
    twins.edits("bob", 12)
    twins.merge_tip("alice")
    ops = {"agent": "w", "version": [["alice", 3]],
           "ops": [{"kind": "ins", "pos": 2, "text": "x😀y"},
                   {"kind": "del", "start": 0, "end": 1}]}
    for src, dst, ol in ((ROOTS[0], ROOTS[1], jol), (ROOTS[1], ROOTS[0], tol)):
        sf, df = _mod(src, "wire.frames"), _mod(dst, "wire.frames")
        frame = sf.encode_frame(sf.FRAME_OPS, sf.encode_ops(ops),
                                compress=True)
        ftype, payload = df.decode_frame(frame)
        assert ftype == df.FRAME_OPS and df.decode_ops(payload) == ops
        snap = _mod(src, "wire.snapshot").build_snapshot(ol)
        fresh = _mod(dst, "text.oplog").OpLog()
        assert _mod(dst, "wire.snapshot").apply_snapshot(fresh, snap)
        assert fresh.checkout_tip().snapshot() == \
            ol.checkout_tip().snapshot()
        assert sorted(fresh.cg.local_to_remote_frontier(fresh.version)) == \
            sorted(ol.cg.local_to_remote_frontier(ol.version))
