"""The port's storage layer against the JAX package's, byte for byte.

Each test runs one script twice, once over each package's `Wal`,
`PageStore`, `DocFile`, `PagedStore`, `PagedDocFile` and `TieredStore`,
in two temporary roots: the same appends, compactions, torn tails and
crash points. The two roots must then hold byte-identical files, and
what each script observed (records, texts, counters) must be equal.
Mirrors `tests/test_storage.py` and the store half of `tests/test_tier.py`.
Histories come from `tests/test_encode.py::build_random_oplog` (carried
into the port with `oplog_from_columns`) and `tests/test_fuzz.py::
random_edit`.
"""

import os
import random
import struct
from pathlib import Path
from types import SimpleNamespace

import pytest

from diamond_types_tpu import OpLog as JOpLog
from diamond_types_tpu.encoding import crc32c as jcrc
from diamond_types_tpu.storage import pages as jpages
from diamond_types_tpu.storage import store as jstore
from diamond_types_tpu.storage import tier as jtier
from diamond_types_tpu_torch import OpLog as TOpLog
from diamond_types_tpu_torch.encoding import crc32c as tcrc
from diamond_types_tpu_torch.storage import pages as tpages
from diamond_types_tpu_torch.storage import store as tstore
from diamond_types_tpu_torch.storage import tier as ttier
from diamond_types_tpu_torch.text.oplog import oplog_from_columns
from tests.test_encode import build_random_oplog
from tests.test_fuzz import random_edit
from tests.torch_parity import export_columns

pytestmark = pytest.mark.storage

JAX = SimpleNamespace(name="jax", store=jstore, pages=jpages, tier=jtier,
                      OpLog=JOpLog, crc32c=jcrc.crc32c,
                      history=lambda seed, steps: build_random_oplog(
                          seed, steps=steps))
PORT = SimpleNamespace(name="port", store=tstore, pages=tpages, tier=ttier,
                       OpLog=TOpLog, crc32c=tcrc.crc32c,
                       history=lambda seed, steps: oplog_from_columns(
                           export_columns(build_random_oplog(seed,
                                                             steps=steps))))


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _both(tmp_path, script):
    """Run `script(pkg, root)` for each package in its own root; the roots
    must end byte-identical and the results equal. Returns the result."""
    out = {}
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name
        root.mkdir()
        out[pkg.name] = script(pkg, str(root))
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    assert out["jax"] == out["port"]
    return out["port"]


def _text(ol) -> str:
    return ol.checkout_tip().snapshot()


def _edit(ol, seed: int, n: int) -> None:
    """`n` random_edit steps by one agent at the tip."""
    rng = random.Random(seed)
    a = ol.get_or_create_agent_id("editor")
    v, c = list(ol.version), _text(ol)
    for _ in range(n):
        v, c = random_edit(rng, ol, a, v, c)


def _mk(pkg, parts, agent="a"):
    ol = pkg.OpLog()
    a = ol.get_or_create_agent_id(agent)
    pos = 0
    for part in parts:
        ol.add_insert(a, pos, part)
        pos += len(part)
    return ol


class _Boom(Exception):
    pass


def _crash_at(point):
    def hook(p):
        if p == point:
            raise _Boom(p)
    return hook


# ---- WAL, PageStore, DocFile (tests/test_storage.py) ---------------------

def test_wal_roundtrip_and_torn_tail(tmp_path):
    def script(pkg, root):
        p = os.path.join(root, "log.wal")
        w = pkg.store.Wal(p)
        w.append(b"alpha")
        w.append(b"beta" * 100)
        w.close()
        with open(p, "ab") as f:
            f.write(b"\x50\x00\x00\x00\xde\xad\xbe\xefpartial")
        w2 = pkg.store.Wal(p)
        first = list(w2.records())
        w2.append(b"gamma")
        out = (first, list(w2.records()))
        w2.close()
        return out
    assert _both(tmp_path, script)[1] == [b"alpha", b"beta" * 100, b"gamma"]


def test_wal_corrupt_middle_stops_replay(tmp_path):
    def script(pkg, root):
        p = os.path.join(root, "log.wal")
        w = pkg.store.Wal(p)
        w.append(b"one")
        w.append(b"two")
        w.close()
        data = bytearray(open(p, "rb").read())
        data[14] ^= 0xFF
        open(p, "wb").write(bytes(data))
        return list(pkg.store.Wal(p).records())
    assert _both(tmp_path, script) == []


def test_pagestore_survives_torn_header(tmp_path):
    def script(pkg, root):
        p = os.path.join(root, "doc.store")
        ps = pkg.store.PageStore(p)
        ps.write(b"generation one")
        ps.write(b"generation two, longer " * 10)
        ps.close()
        data = bytearray(open(p, "rb").read())
        data[10] ^= 0xFF
        open(p, "wb").write(bytes(data))
        ps2 = pkg.store.PageStore(p)
        out = ps2.read()
        ps2.close()
        return out
    assert _both(tmp_path, script) == b"generation one"


@pytest.mark.parametrize("seed", (5, 8))
def test_docfile_persist_reopen_compact(tmp_path, seed):
    def script(pkg, root):
        path = os.path.join(root, "doc.dtstore")
        ol = pkg.history(seed, 30)
        d = pkg.store.DocFile(path)
        d.append_from(ol)
        d.close()
        d2 = pkg.store.DocFile(path)
        texts = [_text(d2.oplog)]
        _edit(ol, seed, 10)
        d2.append_from(ol)
        texts.append(_text(d2.oplog))
        wal = os.path.getsize(path + ".wal")
        d2.compact()
        d2.close()
        d3 = pkg.store.DocFile(path)
        texts.append(_text(d3.oplog))
        d3.close()
        return texts, wal, _text(ol)
    texts, wal, want = _both(tmp_path, script)
    assert texts[1:] == [want, want] and wal > 8


def test_docfile_wal_torn_tail_recovery(tmp_path):
    garbage = random.Random(37).randbytes(37)

    def script(pkg, root):
        path = os.path.join(root, "doc.dtstore")
        ol = pkg.history(9, 20)
        d = pkg.store.DocFile(path)
        d.append_from(ol)
        d.close()
        with open(path + ".wal", "ab") as f:
            f.write(garbage)
        d2 = pkg.store.DocFile(path)
        out = (_text(d2.oplog), _text(ol))
        d2.close()
        return out
    got, want = _both(tmp_path, script)
    assert got == want


# ---- the paged engine (tests/test_storage.py) ----------------------------

def test_paged_roundtrip(tmp_path):
    recs = [b"alpha", b"b" * 10_000, b"", b"tail-rec"]

    def script(pkg, root):
        p = os.path.join(root, "s.pages")
        s = pkg.pages.PagedStore(p)
        for r in recs:
            s.append(1, r)
        s.append(0, b"other-stream")
        s.close()
        s2 = pkg.pages.PagedStore(p)
        out = [list(s2.records(1)), list(s2.records(0))]
        s2.append(1, b"after-reopen")
        s2.close()
        s3 = pkg.pages.PagedStore(p)
        out.append(list(s3.records(1)))
        s3.close()
        return out
    out = _both(tmp_path, script)
    assert out[0] == recs and out[2] == recs + [b"after-reopen"]


def test_paged_write_amplification(tmp_path):
    def script(pkg, root):
        ol = pkg.OpLog()
        a = ol.get_or_create_agent_id("author")
        ol.add_insert_at(a, [], 0, "x" * 100_000)
        path = os.path.join(root, "doc.pages")
        f = pkg.pages.PagedDocFile(path)
        f.append_from(ol)
        before = f.store.bytes_written
        ol.add_insert_at(a, list(ol.version), 5, "!")
        f.append_from(ol)
        delta = f.store.bytes_written - before
        f.close()
        f2 = pkg.pages.PagedDocFile(path)
        ok = _text(f2.oplog) == _text(ol)
        f2.close()
        return delta, ok
    delta, ok = _both(tmp_path, script)
    assert ok and delta <= 3 * tpages.PAGE_SIZE


def test_paged_compact(tmp_path):
    def script(pkg, root):
        ol = pkg.OpLog()
        a = ol.get_or_create_agent_id("author")
        ol.add_insert_at(a, [], 0, "x" * 5_000)
        path = os.path.join(root, "doc.pages")
        f = pkg.pages.PagedDocFile(path)
        f.append_from(ol)
        for i in range(30):
            ol.add_insert_at(a, list(ol.version), 0, f"edit{i} ")
            f.append_from(ol)
        before = os.path.getsize(path)
        f.compact()
        after = os.path.getsize(path)
        f.append_from(ol)
        f.close()
        f2 = pkg.pages.PagedDocFile(path)
        out = (before, after, _text(f2.oplog) == _text(ol))
        f2.close()
        return out
    before, after, ok = _both(tmp_path, script)
    assert after < before and ok


def test_paged_crash_fuzz(tmp_path):
    """Torn and garbled files at seeded byte boundaries, two crash cycles
    each: both packages recover the same prefix and write the same
    bytes after it."""
    def script(pkg, root):
        rng = random.Random(2024)
        seen = []
        for trial in range(8):
            p = os.path.join(root, f"c{trial}.pages")
            s = pkg.pages.PagedStore(p)
            recs = []
            for _ in range(rng.randint(2, 10)):
                r = bytes([rng.randrange(256)]) * rng.randint(1, 9000)
                s.append(1, r)
                recs.append(r)
            s.close()
            data = open(p, "rb").read()
            if rng.random() < 0.5:
                torn = data[:rng.randrange(len(data))]
            else:
                pos = rng.randrange(max(1, len(data) - 64))
                torn = data[:pos] + bytes(
                    rng.randrange(256) for _ in range(32)) + data[pos + 32:]
            open(p, "wb").write(torn)
            s2 = pkg.pages.PagedStore(p)
            got = list(s2.records(1))
            assert got == recs[:len(got)]
            s2.append(1, b"post-crash")
            s2.close()
            data = open(p, "rb").read()
            cut = rng.randrange(max(1, len(data) - 2048), len(data))
            open(p, "wb").write(data[:cut])
            s4 = pkg.pages.PagedStore(p)
            seen.append((len(got), len(list(s4.records(1)))))
            s4.close()
        return seen
    _both(tmp_path, script)


def _newest_image_slot(pkg, path, stream, idx):
    data = open(path, "rb").read()
    hit, hit_key = None, None
    for slot in range(len(data) // pkg.pages.PAGE_SIZE):
        raw = data[slot * pkg.pages.PAGE_SIZE:(slot + 1) * pkg.pages.PAGE_SIZE]
        crc, s, _b, _used, i, gen, seq = pkg.pages._HDR.unpack(
            raw[:pkg.pages._HDR.size])
        if pkg.crc32c(raw[4:]) != crc:
            continue
        if s == stream and i == idx and (hit_key is None
                                         or (gen, seq) > hit_key):
            hit, hit_key = slot, (gen, seq)
    return hit


def test_paged_rollback_suffix_not_respliced(tmp_path):
    rec1 = b"A" * 100
    rec2 = struct.pack("<I", 0) * 2300

    def script(pkg, root):
        P = pkg.pages.PAGE_SIZE
        p = os.path.join(root, "x.pages")
        s = pkg.pages.PagedStore(p)
        s.append(1, rec1)
        s.append(1, rec2)
        s.close()
        slot = _newest_image_slot(pkg, p, 1, 2)
        data = bytearray(open(p, "rb").read())
        data[slot * P:(slot + 1) * P] = b"\0" * P
        open(p, "wb").write(bytes(data))
        s2 = pkg.pages.PagedStore(p)
        out = [list(s2.records(1))]
        s2.append(1, b"fresh")
        s2.close()
        s3 = pkg.pages.PagedStore(p)
        out.append(list(s3.records(1)))
        s3.append(1, b"more")
        s3.close()
        s4 = pkg.pages.PagedStore(p)
        out.append(list(s4.records(1)))
        s4.close()
        return out
    out = _both(tmp_path, script)
    assert out == [[rec1], [rec1, b"fresh"], [rec1, b"fresh", b"more"]]


def test_paged_first_post_recovery_write_torn(tmp_path):
    def script(pkg, root):
        P = pkg.pages.PAGE_SIZE
        out = []
        for n_pre in (1, 2, 3, 4, 5):
            p = os.path.join(root, f"p{n_pre}.pages")
            s = pkg.pages.PagedStore(p)
            recs = [bytes([65 + i]) * (10 + i) for i in range(n_pre)]
            for r in recs:
                s.append(1, r)
            s.close()
            data = open(p, "rb").read()
            open(p, "wb").write(data[:len(data) - P // 2])
            s2 = pkg.pages.PagedStore(p)
            committed = list(s2.records(1))
            s2.append(1, b"after")
            s2.close()
            slot = _newest_image_slot(pkg, p, 1, 0)
            data = bytearray(open(p, "rb").read())
            data[slot * P:(slot + 1) * P] = b"\0" * P
            open(p, "wb").write(bytes(data))
            s3 = pkg.pages.PagedStore(p)
            got3 = list(s3.records(1))
            s3.close()
            assert got3[:len(committed)] == committed
            out.append((committed, got3))
        return out
    _both(tmp_path, script)


# ---- crash-mid-compaction (tests/test_tier.py, store half) ---------------

@pytest.mark.parametrize("point",
                         ["snapshot_written", "replaced", "dir_synced"])
def test_paged_compact_crash_recovers_old_or_new(tmp_path, point):
    def script(pkg, root):
        path = os.path.join(root, "doc.pages")
        f = pkg.pages.PagedDocFile(path)
        f.append_from(_mk(pkg, ["hello ", "world ", "again "]))
        want = _text(f.oplog)
        with pytest.raises(_Boom):
            f.compact(_crash=_crash_at(point))
        f.close()
        stale = os.path.exists(path + ".compact")
        g = pkg.pages.PagedDocFile(path)
        got = _text(g.oplog)
        more = _mk(pkg, ["hello ", "world ", "again ", "post-crash"])
        g.append_from(more)
        g.close()
        h = pkg.pages.PagedDocFile(path)
        out = (stale, got == want, _text(h.oplog) == _text(more))
        h.close()
        return out
    assert _both(tmp_path, script) == (False, True, True)


@pytest.mark.parametrize("point", ["baseline_written", "wal_reset"])
def test_docfile_compact_crash_recovers(tmp_path, point):
    def script(pkg, root):
        path = os.path.join(root, "doc.dt")
        f = pkg.store.DocFile(path)
        f.append_from(_mk(pkg, ["alpha ", "beta "]))
        want = _text(f.oplog)
        with pytest.raises(_Boom):
            f.compact(_crash=_crash_at(point))
        f.close()
        g = pkg.store.DocFile(path)
        out = _text(g.oplog) == want
        g.close()
        return out
    assert _both(tmp_path, script)


def test_stale_compact_rewrite_is_removed_on_open(tmp_path):
    def script(pkg, root):
        path = os.path.join(root, "doc.pages")
        f = pkg.pages.PagedDocFile(path)
        f.append_from(_mk(pkg, ["content"]))
        f.close()
        with open(path + ".compact", "wb") as s:
            s.write(b"half-built rewrite from a dead process")
        g = pkg.pages.PagedDocFile(path)
        out = (os.path.exists(path + ".compact"), _text(g.oplog))
        g.close()
        return out
    assert _both(tmp_path, script) == (False, "content")


# ---- TieredStore ---------------------------------------------------------

def test_tier_roundtrip_and_compaction_policy(tmp_path):
    def script(pkg, root):
        store = pkg.tier.TieredStore(root, compact_patch_records=3)
        ol = pkg.OpLog()
        a = ol.get_or_create_agent_id("w")
        for i in range(5):
            ol.add_insert(a, 0, f"r{i}.")
            store.save("d", ol)
        got = store.load("d")
        out = (got is not ol, _text(got) == _text(ol),
               len(store.load("never-saved")), store.counters())
        return out
    fresh, same, n_new, counters = _both(tmp_path, script)
    assert fresh and same and n_new == 0
    assert counters["saves"] == 5 and counters["compactions"] >= 1
    assert counters["fresh_docs"] == 1


def test_tier_quarantine_is_per_doc(tmp_path):
    def script(pkg, root):
        store = pkg.tier.TieredStore(root)
        for d in ("good", "bad"):
            ol = pkg.OpLog()
            ol.add_insert(ol.get_or_create_agent_id("w"), 0, f"{d} text")
            store.save(d, ol)
        with open(store.path("bad"), "r+b") as f:
            f.write(b"\xff" * os.path.getsize(store.path("bad")))
        reasons = []
        for _ in range(2):          # sticky: the second load rejects too
            with pytest.raises(pkg.tier.DocQuarantined) as ei:
                store.load("bad")
            reasons.append((ei.value.doc_id, ei.value.reason))
        return (reasons, store.is_quarantined("bad"),
                _text(store.load("good")), store.counters())
    reasons, why, good, c = _both(tmp_path, script)
    assert reasons[0][0] == "bad" and why is not None
    assert good == "good text"
    assert c["quarantines"] == 1 and c["quarantined_docs"] == 1


@pytest.mark.parametrize("seed", range(3))
def test_tier_scripted_saves_crashes_and_torn_tails(tmp_path, seed):
    """A seeded script of saves with edits in between, compactions (some
    killed at a crash point), and a torn final page: the homes stay
    byte-identical and every load recovers the same text."""
    def script(pkg, root):
        rng = random.Random(seed)
        store = pkg.tier.TieredStore(root, compact_patch_records=4)
        docs = {f"d{i}": pkg.history(seed * 10 + i, 12) for i in range(3)}
        seen = []
        for step in range(30):
            if not docs:
                break
            d = rng.choice(sorted(docs))
            _edit(docs[d], seed * 100 + step, rng.randint(1, 4))
            store.save(d, docs[d])
            r = rng.random()
            if r < 0.25:
                point = rng.choice(["snapshot_written", "replaced",
                                    "dir_synced"])
                try:
                    store.compact_doc(d, _crash=_crash_at(point))
                except _Boom:
                    pass
                seen.append(("compact", d, point,
                             _text(store.load(d)) == _text(docs[d])))
            elif r < 0.4 and os.path.getsize(store.path(d)) > 2 * PAGE:
                # a write torn by power loss: garble the tail of the last
                # page
                path = store.path(d)
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.seek(size - PAGE // 2)
                    f.write(random.Random(step).randbytes(PAGE // 2))
                try:
                    got = _text(store.load(d))
                except pkg.tier.DocQuarantined as e:
                    seen.append(("quarantined", d, e.reason))
                    del docs[d]
                    continue
                seen.append(("torn", d, got))
                # the home rolled back: carry on from what it holds
                docs[d] = store.load(d)
        seen.append(sorted((d, _text(store.load(d))) for d in docs))
        return seen, store.counters()
    _both(tmp_path, script)


PAGE = tpages.PAGE_SIZE


def test_each_package_loads_the_others_homes(tmp_path):
    """Homes one package's TieredStore wrote load in the other's, to the
    same text (and a save on top of them appends the same bytes)."""
    roots = {}
    for pkg in (JAX, PORT):
        root = tmp_path / pkg.name
        store = pkg.tier.TieredStore(str(root), compact_patch_records=3)
        for i in range(4):
            ol = pkg.history(40 + i, 25)
            store.save(f"doc{i}", ol)
            _edit(ol, i, 6)
            store.save(f"doc{i}", ol)
        roots[pkg.name] = root
    assert _files(roots["jax"]) == _files(roots["port"])
    for reader, writer in ((PORT, "jax"), (JAX, "port")):
        store = reader.tier.TieredStore(str(roots[writer]))
        other = (JAX if reader is PORT else PORT).tier.TieredStore(
            str(roots[writer]))
        for i in range(4):
            assert _text(store.load(f"doc{i}")) \
                == _text(other.load(f"doc{i}"))
