"""The port's `.dt` codec, summaries and wire frames against the JAX
package's, byte for byte.

The same seeded histories go into a JAX OpLog and a port OpLog
(`tests/test_encode.py::build_random_oplog` carried across with
`torch_parity.export_columns` / `oplog_from_columns`, and `TwinDocs`
rounds with unicode text). Every writer, native and Python, in each
package must give the same bytes; each package must load the other's
files to the same text, version and graph rows; corrupt input raises
`ParseError` in both. Exact: no tolerance anywhere.
"""

import random

import numpy as np
import pytest

from diamond_types_tpu import OpLog as JOpLog
from diamond_types_tpu.causalgraph import summary as jsummary
from diamond_types_tpu.encoding import crc32c as jcrc
from diamond_types_tpu.encoding import decode as jdec
from diamond_types_tpu.encoding import encode as jenc
from diamond_types_tpu.encoding import lz4 as jlz4
from diamond_types_tpu.wire import frames as jframes
from diamond_types_tpu.wire import snapshot as jsnap
from diamond_types_tpu_torch import OpLog as TOpLog
from diamond_types_tpu_torch.causalgraph import summary as tsummary
from diamond_types_tpu_torch.encoding import crc32c as tcrc
from diamond_types_tpu_torch.encoding import decode as tdec
from diamond_types_tpu_torch.encoding import encode as tenc
from diamond_types_tpu_torch.encoding import lz4 as tlz4
from diamond_types_tpu_torch.native import core as tcore
from diamond_types_tpu_torch.text.oplog import oplog_from_columns
from diamond_types_tpu_torch.wire import frames as tframes
from diamond_types_tpu_torch.wire import snapshot as tsnap
from tests.test_encode import build_random_oplog
from tests.torch_parity import UNICODE, TwinDocs, export_columns

pytestmark = pytest.mark.storage

WRITERS = ("native", "python")


@pytest.fixture
def writer(request, monkeypatch):
    """Selects the writer both packages use: "python" sets
    DT_TPU_NO_NATIVE, which both packages' writers read."""
    if request.param == "native":
        assert tcore.native_available()
        monkeypatch.delenv("DT_TPU_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    return request.param


def _pair_random(seed: int, steps: int = 40):
    """A JAX build_random_oplog and the same history in the port."""
    jol = build_random_oplog(seed, steps=steps)
    return jol, oplog_from_columns(export_columns(jol))


def _pair_twin(seed: int, rounds: int = 3):
    tw = TwinDocs([JOpLog(), TOpLog()], seed, alphabet=UNICODE)
    tw.type_base("alice", 40)
    names = ("alice", "bob", "carol")
    for _ in range(rounds):
        tw.fork(names)
        tw.concurrent_round(names, 4)
    return tw.oplogs


def _pairs():
    return [("random", s) for s in range(4)] + [("twin", s) for s in (1, 2)]


def _make(kind, seed):
    return _pair_random(seed) if kind == "random" else _pair_twin(seed)


def _mid_version(ol):
    """The frontier after the first half of the ops (a patch base)."""
    half = max(len(ol) // 2, 1)
    return ol.cg.graph.find_dominators([half - 1])


def _state(ol):
    g = ol.cg.graph
    return (ol.checkout_tip().snapshot(), sorted(ol.version),
            [a.tolist() for a in g.as_arrays()],
            list(ol.cg.agent_assignment.agent_names))


@pytest.mark.parametrize("writer", WRITERS, indirect=True)
@pytest.mark.parametrize("kind,seed", _pairs())
def test_encode_bytes_identical_full_and_patch(kind, seed, writer):
    jol, tol = _make(kind, seed)
    assert _state(jol) == _state(tol)
    for opts_name in ("ENCODE_FULL", "ENCODE_PATCH"):
        jo, to = getattr(jenc, opts_name), getattr(tenc, opts_name)
        assert jenc.encode_oplog(jol, jo) == tenc.encode_oplog(tol, to)
        frm = _mid_version(jol)
        assert frm == _mid_version(tol)
        jb = jenc.encode_oplog(jol, jo, from_version=frm)
        assert jb == tenc.encode_oplog(tol, to, from_version=frm)


@pytest.mark.parametrize("kind,seed", _pairs())
def test_native_writer_equals_python_writer(kind, seed, monkeypatch):
    _jol, tol = _make(kind, seed)
    frm = _mid_version(tol)
    native = [tenc.encode_oplog(tol, tenc.ENCODE_FULL),
              tenc.encode_oplog(tol, tenc.ENCODE_PATCH, from_version=frm)]
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    python = [tenc.encode_oplog(tol, tenc.ENCODE_FULL),
              tenc.encode_oplog(tol, tenc.ENCODE_PATCH, from_version=frm)]
    assert native == python


@pytest.mark.parametrize("writer", WRITERS, indirect=True)
@pytest.mark.parametrize("kind,seed", _pairs())
def test_each_package_loads_the_others_files(kind, seed, writer):
    """Port-written files load in JAX, JAX-written files in the port (the
    fresh load goes through the C++ parser unless DT_TPU_NO_NATIVE), with
    equal text, version, graph rows and agents; a patch file decodes onto
    the base it was cut from."""
    jol, tol = _make(kind, seed)
    tbytes = tenc.encode_oplog(tol, tenc.ENCODE_FULL)
    jbytes = jenc.encode_oplog(jol, jenc.ENCODE_FULL)
    # the file numbers ops in its own order: every load of it has the
    # same rows, and the source's text and remote version
    want = _state(jdec.load_oplog(jbytes))
    assert want[0] == jol.checkout_tip().snapshot()
    for dec, data in ((jdec, tbytes), (tdec, jbytes), (tdec, tbytes)):
        got = dec.load_oplog(data)
        assert _state(got) == want
        assert sorted(got.cg.local_to_remote_frontier(got.version)) \
            == sorted(jol.cg.local_to_remote_frontier(jol.version))
    # a patch from the mid version decodes onto a base holding only the
    # ops up to that version (a fresh load of the same file is the base)
    frm = _mid_version(jol)
    jpatch = jenc.encode_oplog(jol, jenc.ENCODE_PATCH, from_version=frm)
    tpatch = tenc.encode_oplog(tol, tenc.ENCODE_PATCH, from_version=frm)
    jbase = jdec.load_oplog(jenc.encode_oplog(jol.__class__(),
                                              jenc.ENCODE_FULL))
    tbase = tdec.load_oplog(tenc.encode_oplog(TOpLog(), tenc.ENCODE_FULL))
    jdec.decode_into(jbase, jenc.encode_oplog(jol, jenc.ENCODE_PATCH,
                                              from_version=[]))
    tdec.decode_into(tbase, tenc.encode_oplog(tol, tenc.ENCODE_PATCH,
                                              from_version=[]))
    jdec.decode_into(jbase, tpatch)
    tdec.decode_into(tbase, jpatch)
    assert _state(jbase) == _state(tbase)
    assert _state(tbase)[0] == want[0]


def _corruptions(data: bytes):
    rng = np.random.default_rng(len(data))
    out = [data[:8] + b"\x00" + data[9:],              # protocol version
           b"NOTADTFL" + data[8:],                     # magic
           data[:len(data) // 2]]                      # truncated
    for _ in range(4):                                 # bit flips
        b = bytearray(data)
        i = int(rng.integers(12, len(b)))
        b[i] ^= 1 << int(rng.integers(8))
        out.append(bytes(b))
    return out


@pytest.mark.parametrize("writer", WRITERS, indirect=True)
@pytest.mark.parametrize("seed", range(3))
def test_corrupt_input_raises_parse_error_in_both(seed, writer):
    jol, tol = _pair_random(seed)
    data = tenc.encode_oplog(tol, tenc.ENCODE_FULL)
    for bad in _corruptions(data):
        outcomes = []
        for dec in (jdec, tdec):
            try:
                ol = dec.load_oplog(bad)
                outcomes.append(("ok", ol.checkout_tip().snapshot()))
            except dec.ParseError:
                outcomes.append(("ParseError", None))
        # the CRC catches every flip the structure does not: both
        # packages reject (or, for a flip in a field the CRC skips,
        # accept to the same text)
        assert outcomes[0] == outcomes[1], outcomes
    for dec in (jdec, tdec):
        with pytest.raises(dec.ParseError):
            dec.load_oplog(b"NOTADTFL" + data[8:])


def test_native_parse_error_maps_to_parse_error():
    _jol, tol = _pair_random(0)
    data = bytearray(tenc.encode_oplog(tol, tenc.ENCODE_FULL))
    data[8] = 0x7f                   # an unsupported protocol version
    with pytest.raises(tcore.NativeParseError):
        tcore.decode_file_native(bytes(data))
    with pytest.raises(tdec.ParseError):
        tdec.load_oplog(bytes(data))


def _blobs():
    rng = random.Random(99)
    out = [b"", b"a", b"abcd" * 3, bytes(range(256)) * 5,
           ("héllo 世界 \U0001f600 " * 300).encode("utf8")]
    for n in (17, 4096, 70_000):
        # runs of repeats (matches) among random bytes (literals), and a
        # long-offset repeat past 0xFFFF
        chunk = bytes(rng.randrange(256) for _ in range(n))
        out.append(chunk + chunk[: n // 3] + b"z" * 300)
    return out


def test_crc32c_and_lz4_native_python_and_jax_identical(monkeypatch):
    assert tcore.native_available()
    for blob in _blobs():
        want_crc = jcrc.crc32c(blob)
        assert tcrc.crc32c(blob) == want_crc
        assert tcore.crc32c_native(blob) == want_crc
        assert tcrc.crc32c_py(blob) == want_crc
        assert tcrc.crc32c(blob[7:], tcrc.crc32c(blob[:7])) == want_crc
        want_lz4 = jlz4.lz4_compress_block(blob)
        assert tlz4.lz4_compress_block(blob) == want_lz4
        assert tcore.lz4_compress_native(blob) == want_lz4
        assert tlz4.lz4_compress_block_py(blob) == want_lz4
        assert tlz4.lz4_decompress_block(want_lz4, len(blob)) == blob
    # without the library the entry points run the Python loops
    monkeypatch.setattr(tcore, "native_available", lambda: False)
    blob = _blobs()[-1]
    assert tcore.crc32c_native(blob) is None
    assert tcore.lz4_compress_native(blob) is None
    assert tcrc.crc32c(blob) == jcrc.crc32c(blob)
    assert tlz4.lz4_compress_block(blob) == jlz4.lz4_compress_block(blob)


def test_fresh_load_without_the_library_uses_the_python_decoder(
        monkeypatch):
    jol, tol = _pair_random(3)
    data = tenc.encode_oplog(tol, tenc.ENCODE_FULL)
    monkeypatch.setattr(tcore, "native_available", lambda: False)
    assert tcore.decode_file_native(data) is None
    assert tcore.graph_rebuild_native([0], [1], [0, 0], []) is None
    assert _state(tdec.load_oplog(data)) == _state(jdec.load_oplog(data))


def test_decoder_failure_propagates(monkeypatch):
    """A failure of the C++ decoder other than a parse error is not
    swallowed into the Python path."""
    _jol, tol = _pair_random(1)
    data = tenc.encode_oplog(tol, tenc.ENCODE_FULL)

    def boom(_data):
        raise OSError("library fault")

    monkeypatch.setattr(tcore, "decode_file_native", boom)
    with pytest.raises(OSError, match="library fault"):
        tdec.load_oplog(data)


@pytest.mark.parametrize("kind,seed", _pairs())
def test_summaries_equal(kind, seed):
    jol, tol = _make(kind, seed)
    js, ts = jsummary.summarize_versions(jol.cg), \
        tsummary.summarize_versions(tol.cg)
    assert js == ts
    assert jsummary.summarize_versions_flat(jol.cg) \
        == tsummary.summarize_versions_flat(tol.cg)
    # a peer that holds the first half: the common version and what it
    # lacks agree
    half_j = jdec.load_oplog(jenc.encode_oplog(
        jol, jenc.ENCODE_FULL))
    peer = jsummary.summarize_versions(half_j.cg)
    peer = {a: [[s, max(s, e - 2)] for s, e in runs]
            for a, runs in peer.items()}
    peer["stranger"] = [[0, 5]]
    assert jsummary.intersect_with_summary(jol.cg, peer) \
        == tsummary.intersect_with_summary(tol.cg, peer)
    flat = jsummary.summarize_versions_flat(half_j.cg)
    assert jsummary.intersect_with_flat_summary(jol.cg, flat) \
        == tsummary.intersect_with_flat_summary(tol.cg, flat)


def test_wire_frames_byte_identical():
    rng = random.Random(5)
    alphabet = "etaoin shrdluéß世界\U0001f600é"
    for _ in range(20):
        ops = []
        for _ in range(rng.randrange(0, 20)):
            if rng.random() < 0.3:
                s = rng.randrange(50)
                ops.append({"kind": "del", "start": s,
                            "end": s + 1 + rng.randrange(5)})
            else:
                ops.append({"kind": "ins", "pos": rng.randrange(60),
                            "text": "".join(rng.choice(alphabet) for _
                                            in range(rng.randrange(1, 9)))})
        req = {"agent": f"a{rng.randrange(9)}",
               "version": [["alice", rng.randrange(900)]], "ops": ops}
        jp, tp = jframes.encode_ops(req), tframes.encode_ops(req)
        assert jp == tp and tframes.decode_ops(jp) == req
        for compress in (False, True):
            jf = jframes.encode_frame(jframes.FRAME_OPS, jp * 8,
                                      compress=compress)
            assert jf == tframes.encode_frame(tframes.FRAME_OPS, tp * 8,
                                              compress=compress)
            assert tframes.decode_frame(jf) == (tframes.FRAME_OPS, tp * 8)
    summary = {"alice": [[0, 10], [20, 31]], "bøb": [[5, 9]]}
    assert jframes.encode_summary(summary) == tframes.encode_summary(summary)
    state = ("héllo 世界", [["alice", 7]])
    assert jframes.encode_state(*state) == tframes.encode_state(*state)
    recs = [b"DMNDTYPS" + bytes(range(40)), b"", b"\x00" * 9]
    assert jframes.encode_records(recs) == tframes.encode_records(recs)
    bad = bytearray(jframes.encode_frame(jframes.FRAME_STATE, b"x" * 40))
    bad[-1] ^= 0xFF
    with pytest.raises(tframes.WireError):
        tframes.decode_frame(bytes(bad))


@pytest.mark.parametrize("seed", range(2))
def test_snapshot_frames_cross_apply(seed):
    jol, tol = _pair_random(seed)
    jf, tf = jsnap.build_snapshot(jol), tsnap.build_snapshot(tol)
    assert jf == tf
    got_t, got_j = TOpLog(), JOpLog()
    assert tsnap.apply_snapshot(got_t, jf) == len(jol)
    assert jsnap.apply_snapshot(got_j, tf) == len(tol)
    assert tsnap.apply_snapshot(got_t, jf) == 0        # dedup-safe
    assert _state(got_t) == _state(got_j)
    assert _state(got_t)[0] == jol.checkout_tip().snapshot()
    with pytest.raises(tframes.WireError):
        tsnap.apply_snapshot(TOpLog(),
                             tframes.encode_frame(tframes.FRAME_PATCH, b"x"))
