"""The port's sync server (`tools/server.py`) against the JAX package's.

`tests/test_server.py`'s cases run once against the JAX package's server
and once against the port's, on `device="cpu"`, with the same clients
(the positional browser client, the CRDT peer and `SyncClient`) and the
same scripts; what each run observes (texts, versions, status codes,
persisted files, the history strip) must be equal. `tools/web_assets.py`,
`tools/py2js.py` and `tools/crdt_replay_src.py` are byte-identical
copies, so the pages the two servers serve are equal too.

The port's server differs from JAX's on purpose, and these tests pin it:
`serve(serve_shards=N)` builds the fused device scheduler with the device
plan on `device` (None: CUDA, which must exist; no host engine), so with
no CUDA and no device it raises; the DT_SERVER_DEVICE history strip runs
`gpu/plan_kernels.texts_at_versions` (K3) on the server's device and
raises without CUDA when none was asked for; and `serve(follower_reads=
True)` raises ImportError until `read/` is ported. On a card (the `cuda`
marker) the device strip equals the host strip and a two-node port mesh
converges with the admit gate on.
"""

import importlib
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.serve

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = ROOTS = ("diamond_types_tpu", "diamond_types_tpu_torch")
COPIED = ("tools/__init__.py", "tools/web_assets.py", "tools/py2js.py",
          "tools/crdt_replay_src.py")


def _mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


def _both(scenario, *args):
    jax_obs = scenario(JAX, *args)
    port_obs = scenario(PORT, *args)
    assert port_obs == jax_obs
    return port_obs


def _serve(root, **kw):
    if root == PORT:
        kw.setdefault("device", "cpu")
    httpd = _mod(root, "tools.server").serve(**kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _api(base, doc, action, body):
    req = urllib.request.Request(f"{base}/doc/{doc}/{action}",
                                 data=json.dumps(body).encode("utf8"))
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _status(fn) -> int:
    try:
        fn()
        return 200
    except urllib.error.HTTPError as e:
        return e.code


def _get(url: str) -> str:
    with urllib.request.urlopen(url) as r:
        return r.read().decode("utf8")


class DumbClient:
    """The browser editor's loop (web_assets.py): positional edits at a
    remembered version, OT catch-up through `root`'s `text.ot`."""

    def __init__(self, root, base, doc, agent):
        self.ot = _mod(root, "text.ot")
        self.base, self.doc, self.agent = base, doc, agent
        st = json.loads(_get(f"{base}/doc/{doc}/state"))
        self.text, self.version = st["text"], st["version"]

    def edit(self, ops):
        for op in ops:
            if op["kind"] == "ins":
                p = op["pos"]
                self.text = self.text[:p] + op["text"] + self.text[p:]
            else:
                self.text = self.text[:op["start"]] + self.text[op["end"]:]
        r = _api(self.base, self.doc, "edit",
                 {"agent": self.agent, "version": self.version, "ops": ops})
        self.version = r["version"]

    def sync(self):
        r = _api(self.base, self.doc, "changes", {"version": self.version})
        self.text = self.ot.apply(self.text, r["op"])
        self.version = r["version"]


class CrdtPeer:
    """The Python twin of the in-browser CRDT peer of tests/test_server.py:
    original unit ops with explicit parents over /doc/{id}/ops."""

    def __init__(self, base, doc, name):
        self.base, self.doc, self.name = base, doc, name
        self.seq = 0
        self.frontier = []
        self.pending = []
        self.known = {}

    def edit_ins(self, pos, text):
        for i, ch in enumerate(text):
            self.pending.append({"agent": self.name, "seq": self.seq,
                                 "parents": self.frontier, "kind": "ins",
                                 "pos": pos + i, "content": ch})
            self.frontier = [[self.name, self.seq]]
            self.seq += 1
        self.known[self.name] = self.seq

    def edit_del(self, pos, n):
        for _ in range(n):
            self.pending.append({"agent": self.name, "seq": self.seq,
                                 "parents": self.frontier, "kind": "del",
                                 "pos": pos, "len": 1})
            self.frontier = [[self.name, self.seq]]
            self.seq += 1
        self.known[self.name] = self.seq

    def sync(self):
        body = json.dumps({"have": self.known, "push": self.pending})
        req = urllib.request.Request(f"{self.base}/doc/{self.doc}/ops",
                                     data=body.encode("utf8"))
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        self.pending = []
        for row in out["ops"]:
            units = len(row.get("content") or "") if row["kind"] == "ins" \
                else row["len"]
            self.known[row["agent"]] = max(self.known.get(row["agent"], 0),
                                            row["seq"] + units)
        f = {a: s for a, s in self.frontier}
        for a, s in out["version"]:
            if a != self.name:
                f[a] = max(f.get(a, -1), s)
        self.frontier = [[a, s] for a, s in f.items()]
        return out


def _units(out) -> int:
    return sum(len(r.get("content") or "") if r["kind"] == "ins"
               else r["len"] for r in out["ops"])


# ---- the copies and the pages ------------------------------------------------

@pytest.mark.parametrize("rel", COPIED)
def test_module_is_a_byte_identical_copy(rel):
    assert (REPO / PORT / rel).read_bytes() == (REPO / JAX / rel).read_bytes()


def test_server_keeps_jax_api():
    import inspect
    js, ts = (_mod(r, "tools.server") for r in ROOTS)
    for name in ("DocStore", "SyncHandler", "SyncClient", "serve", "main",
                 "doc_history_strip"):
        assert hasattr(ts, name), name
    jp = inspect.signature(js.serve).parameters
    tp = inspect.signature(ts.serve).parameters
    assert list(tp) == list(jp) + ["device"]
    assert tp["device"].default is None
    assert list(inspect.signature(ts.doc_history_strip).parameters) == \
        list(inspect.signature(js.doc_history_strip).parameters) + ["device"]


# ---- tests/test_server.py through both servers ---------------------------------

def _two_clients(root, tmp_path):
    srv = _mod(root, "tools.server")
    d = tmp_path / root
    httpd, base = _serve(root, port=0, data_dir=str(d))
    try:
        a = srv.SyncClient(base, "note", "alice")
        b = srv.SyncClient(base, "note", "bob")
        a.insert(0, "Hello from alice. ")
        a.sync()
        b.pull()
        out = [b.text()]
        b.insert(len(b.text()), "And bob!")
        a.insert(0, ">> ")
        a.sync()
        b.sync()
        a.sync()
        out += [a.text(), b.text()]
        httpd.RequestHandlerClass.store.flush(force=True)
        ol = _mod(root, "encoding.decode").load_oplog(
            (d / "note.dt").read_bytes())
        out.append(ol.checkout_tip().snapshot())
        return out
    finally:
        _stop(httpd)


def test_two_clients_collaborate(tmp_path):
    got = _both(_two_clients, tmp_path)
    assert got[0] == "Hello from alice. "
    assert got[1] == got[2] == got[3]
    assert "And bob!" in got[1] and ">> " in got[1]


def _dumb_clients(root, tmp_path):
    SyncClient = _mod(root, "tools.server").SyncClient
    httpd, base = _serve(root, port=0, data_dir=str(tmp_path / root))
    try:
        w1 = DumbClient(root, base, "page", "web-one")
        w1.edit([{"kind": "ins", "pos": 0, "text": "The quick brown fox"}])
        w2 = DumbClient(root, base, "page", "web-two")
        w2.sync()
        out = [w2.text]
        c = SyncClient(base, "page", "carol")
        c.pull()
        w1.edit([{"kind": "ins", "pos": 0, "text": ">> "}])
        w2.edit([{"kind": "del", "start": 10, "end": 16},
                 {"kind": "ins", "pos": 10, "text": "red"}])
        c.insert(4, "very ")
        c.sync()
        for cl in (w1, w2):
            cl.sync()
        c.sync()
        w1.sync()
        return out + [w1.text, w2.text, c.text(), w1.version]
    finally:
        _stop(httpd)


def test_browser_dumb_clients_converge(tmp_path):
    got = _both(_dumb_clients, tmp_path)
    assert got[0] == "The quick brown fox"
    assert got[1] == got[2] == got[3] and got[1].startswith(">> ")
    assert "red" in got[1] and "very" in got[1]


def _pages_and_graph(root, tmp_path):
    httpd, base = _serve(root, port=0, data_dir=str(tmp_path / root))
    try:
        w = DumbClient(root, base, "g", "web")
        w.edit([{"kind": "ins", "pos": 0, "text": "hello"}])
        w.edit([{"kind": "ins", "pos": 5, "text": " world"}])
        pages = [_get(base + p) for p in ("/", "/edit/g", "/vis/g",
                                          "/crdt/g")]
        g = json.loads(_get(base + "/doc/g/graph"))
        last = g["runs"][-1]["end"] - 1
        return {"pages": pages, "graph": g,
                "at": [_api(base, "g", "at", {"lv": last})["text"],
                       _api(base, "g", "at", {"lv": 4})["text"]]}
    finally:
        _stop(httpd)


def test_browser_pages_and_graph_endpoints(tmp_path):
    got = _both(_pages_and_graph, tmp_path)
    assert all("<title>" in p or "<h1>" in p for p in got["pages"])
    assert got["graph"]["runs"][0]["agent"] == "web"
    assert got["at"] == ["hello world", "hello"]


def _bad_ops(root, tmp_path):
    httpd, base = _serve(root, port=0, data_dir=str(tmp_path / root))
    try:
        w = DumbClient(root, base, "v", "web")
        w.edit([{"kind": "ins", "pos": 0, "text": "hello"}])
        codes = []
        for bad in ([{"kind": "ins", "pos": 0, "text": ""}],
                    [{"kind": "ins", "pos": 99, "text": "x"}],
                    [{"kind": "del", "start": 2, "end": 2}],
                    [{"kind": "del", "start": 0, "end": 99}],
                    [{"kind": "nop"}],
                    [{"kind": "ins", "pos": 0, "text": "A"},
                     {"kind": "del", "start": 50, "end": 60}],
                    [{"kind": "ins", "pos": 1.5, "text": "x"}],
                    [{"kind": "ins", "pos": "2", "text": "x"}],
                    [{"kind": "del", "start": 0.5, "end": 2}]):
            codes.append(_status(lambda: _api(
                base, "v", "edit",
                {"agent": "web", "version": w.version, "ops": bad})))
        for action, payload in (
                ("at", {}), ("at", {"lv": "zero"}), ("at", {"lv": 10**9}),
                ("at", {"lv": -1}), ("edit", {"agent": "web"}),
                ("edit", {"agent": 7, "version": [],
                          "ops": [{"kind": "ins", "pos": 0, "text": "x"}]}),
                ("changes", {"wait": "soon"})):
            codes.append(_status(lambda: _api(base, "v", action, payload)))
        codes.append(_status(lambda: urllib.request.urlopen(
            urllib.request.Request(f"{base}/doc/v/at", data=b"not json"))))
        return codes + [_get(f"{base}/doc/v")]
    finally:
        _stop(httpd)


def test_edit_endpoint_rejects_bad_ops(tmp_path):
    assert _both(_bad_ops, tmp_path) == [400] * 17 + ["hello"]


def _flush_races(root, tmp_path):
    d = tmp_path / root
    httpd, base = _serve(root, port=0, data_dir=str(d))
    store = httpd.RequestHandlerClass.store
    store.save_interval = 0.0
    try:
        errs = []

        def hammer(name):
            try:
                w = DumbClient(root, base, "r", name)
                for i in range(40):
                    w.edit([{"kind": "ins", "pos": 0, "text": f"{name}{i} "}])
                    w.sync()
            except Exception as e:  # pragma: no cover - reported below
                errs.append(e)

        ts = [threading.Thread(target=hammer, args=(n,))
              for n in ("alice", "bob")]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        store.flush(force=True)
        ol = _mod(root, "encoding.decode").load_oplog(
            (d / "r.dt").read_bytes())
        text = ol.checkout_tip().snapshot()
        return [errs, len(ol), sorted(text.split())]
    finally:
        _stop(httpd)


def test_flush_races_concurrent_edits(tmp_path):
    """The interleaving of the two writers differs run to run, so the
    persisted documents are compared by their ops and words."""
    got = _both(_flush_races, tmp_path)
    assert got[0] == [] and got[1] > 0
    assert got[2] == sorted(f"{n}{i}" for n in ("alice", "bob")
                            for i in range(40))


def _encode_backoff(root, tmp_path, capsys):
    srv = _mod(root, "tools.server")
    d = tmp_path / root
    store = srv.DocStore(data_dir=str(d), save_interval=0.0)

    class Bomb:
        armed = True

    real_encode = srv.encode_oplog

    def fake_encode(ol, *a, **k):
        if isinstance(ol, Bomb) and ol.armed:
            raise ValueError("poisoned")
        if isinstance(ol, Bomb):
            return b"ok"
        return real_encode(ol, *a, **k)

    srv.encode_oplog = fake_encode
    capsys.readouterr()
    try:
        bomb = Bomb()
        store.docs["bad"] = bomb
        store.mark_dirty("bad")
        for _ in range(6):
            store.flush()
        out = [store.flush_failures["bad"],
               store.dirty["bad"] > time.monotonic(),
               capsys.readouterr().err.count("Traceback")]
        store.mark_dirty("bad")
        store.flush()
        out.append(store.flush_failures["bad"])
        bomb.armed = False
        store.mark_dirty("bad")
        store.flush()
        out += ["bad" in store.flush_failures, (d / "bad.dt").read_bytes()]
        return out
    finally:
        srv.encode_oplog = real_encode


def test_flush_encode_failure_backoff(tmp_path, capsys):
    got = _both(_encode_backoff, tmp_path, capsys)
    assert got[0] >= 1 and got[1] and got[2] == 1
    assert got[3] == got[0] + 1 and got[4:] == [False, b"ok"]


def _write_backoff(root, tmp_path, capsys):
    srv = _mod(root, "tools.server")
    d = tmp_path / root
    store = srv.DocStore(data_dir=str(d), save_interval=0.0)
    for name, text in (("aa", "first"), ("bb", "second")):
        ol = _mod(root, "text.oplog").OpLog()
        ol.add_insert_at(ol.get_or_create_agent_id("u"), [], 0, text)
        store.docs[name] = ol
        store.mark_dirty(name)
    real_replace = srv.os.replace

    def flaky_replace(src, dst):
        if dst.endswith("aa.dt"):
            raise OSError(28, "No space left on device")
        return real_replace(src, dst)

    capsys.readouterr()
    srv.os.replace = flaky_replace
    try:
        store.flush()
        out = [(d / "bb.dt").exists(), (d / "aa.dt").exists(),
               store.flush_failures["aa"], "aa" in store.dirty,
               "bb" in store.dirty,
               "write failed" in capsys.readouterr().err]
    finally:
        srv.os.replace = real_replace
    store.mark_dirty("aa")
    store.flush()
    return out + [(d / "aa.dt").exists(), "aa" in store.flush_failures,
                  (d / "aa.dt").read_bytes(), (d / "bb.dt").read_bytes()]


def test_flush_write_failure_remarks_dirty(tmp_path, capsys):
    got = _both(_write_backoff, tmp_path, capsys)
    assert got[:6] == [True, False, 1, True, False, True]
    assert got[6:8] == [True, False]


def _long_poll(root, tmp_path):
    ot = _mod(root, "text.ot")
    httpd, base = _serve(root, port=0, data_dir=str(tmp_path / root))
    try:
        w = DumbClient(root, base, "lp", "writer")
        w.edit([{"kind": "ins", "pos": 0, "text": "start"}])
        r = DumbClient(root, base, "lp", "reader")
        r.sync()
        result = {}

        def waiter():
            t0 = time.monotonic()
            result["resp"] = _api(base, "lp", "changes",
                                  {"version": r.version, "wait": 10})
            result["latency"] = time.monotonic() - t0

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.4)
        w.edit([{"kind": "ins", "pos": 5, "text": "!"}])
        th.join(timeout=8)
        out = [not th.is_alive(), result["latency"] < 5,
               ot.apply(r.text, result["resp"]["op"])]
        r.sync()
        t0 = time.monotonic()
        resp = _api(base, "lp", "changes", {"version": r.version,
                                            "wait": 0.5})
        return out + [resp["op"], time.monotonic() - t0 < 3]
    finally:
        _stop(httpd)


def test_changes_long_poll_streams_edits(tmp_path):
    assert _both(_long_poll, tmp_path) == [True, True, "start!", [], True]


def _concurrent_oplog(root):
    ol = _mod(root, "text.oplog").OpLog()
    a = ol.get_or_create_agent_id("a")
    b = ol.get_or_create_agent_id("b")
    v = [ol.add_insert_at(a, [], 0, "base text here")]
    ol.add_insert_at(a, v, 0, "A1 ")
    ol.add_insert_at(b, v, 14, " B1")
    return ol


def _history_endpoint(root, monkeypatch):
    monkeypatch.setenv("DT_SERVER_DEVICE", "1")
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        enc = _mod(root, "encoding.encode")
        ol = _concurrent_oplog(root)
        urllib.request.urlopen(urllib.request.Request(
            base + "/doc/h1/push",
            data=enc.encode_oplog(ol, enc.ENCODE_FULL))).read()
        out = json.loads(urllib.request.urlopen(urllib.request.Request(
            base + "/doc/h1/history",
            data=json.dumps({"n": 8}).encode("utf8"))).read())
        return [out["snapshots"], ol.checkout_tip().snapshot()]
    finally:
        monkeypatch.delenv("DT_SERVER_DEVICE")
        _stop(httpd)


def test_history_strip_endpoint(monkeypatch):
    """With DT_SERVER_DEVICE the strip is one texts_at_versions call: the
    JAX package's on its CPU backend, the port's on the server's device
    (the CPU here: the plain versions)."""
    snaps, tip = _both(_history_endpoint, monkeypatch)
    assert len(snaps) >= 2 and snaps[-1]["text"] == tip
    assert [s["lv"] for s in snaps] == sorted(s["lv"] for s in snaps)


def _host_strip(root):
    strip = _mod(root, "tools.server").doc_history_strip
    ol = _mod(root, "text.oplog").OpLog()
    a = ol.get_or_create_agent_id("a")
    b = ol.get_or_create_agent_id("b")
    v = [ol.add_insert_at(a, [], 0, "0123456789")]
    ol.add_insert_at(a, v, 0, "A")
    ol.add_insert_at(b, v, 10, "B")
    return [strip(ol, 6), strip(ol, 1), ol.checkout_tip().snapshot()]


def test_history_strip_host_path():
    snaps, one, tip = _both(_host_strip)
    assert len(snaps) >= 2 and snaps[-1]["text"] == tip
    assert [s["lv"] for s in snaps] == sorted(s["lv"] for s in snaps)
    assert one[-1]["text"] == tip


def _crdt_concurrent(root):
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        p1 = CrdtPeer(base, "cdoc", "anna")
        p2 = CrdtPeer(base, "cdoc", "bert")
        p1.edit_ins(0, "hello world")
        p1.sync()
        p2.sync()
        p1.edit_ins(5, "-A")
        p2.edit_ins(5, "-B")
        p1.edit_del(0, 1)
        p1.sync()
        p2.sync()
        p1.sync()
        ol = httpd.RequestHandlerClass.store.get("cdoc")
        text = ol.checkout_tip().snapshot()
        out = [text, _units(CrdtPeer(base, "cdoc", "cara").sync()),
               len(ol)]
        p4 = CrdtPeer(base, "cdoc", "anna")
        p4.edit_ins(0, "h")
        p4.pending[0]["parents"] = []
        p4.sync()
        return out + [ol.checkout_tip().snapshot()]
    finally:
        _stop(httpd)


def test_crdt_peer_protocol_concurrent():
    text, units, n, again = _both(_crdt_concurrent)
    assert "-A" in text and "-B" in text
    assert text.startswith("ello") and text.endswith("world")
    assert units == n and again == text


def _crdt_order_free(root):
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        a = CrdtPeer(base, "odoc", "aa")
        b = CrdtPeer(base, "odoc", "bb")
        a.edit_ins(0, "base ")
        a.sync()
        b.sync()
        a.edit_ins(5, "AAA")
        b.edit_ins(5, "BBB")
        b.sync()
        a.sync()
        b.sync()
        return httpd.RequestHandlerClass.store.get("odoc") \
            .checkout_tip().snapshot()
    finally:
        _stop(httpd)


def test_crdt_peer_offline_convergence_order_free():
    assert _both(_crdt_order_free) == "base AAABBB"


def _crdt_out_of_range(root):
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        p = CrdtPeer(base, "vdoc", "anna")
        p.edit_ins(0, "hello")
        p.sync()
        ol = httpd.RequestHandlerClass.store.get("vdoc")
        frontier = [["anna", 4]]

        def push(op):
            body = json.dumps({"have": {}, "push": [op]}).encode("utf8")
            return urllib.request.urlopen(urllib.request.Request(
                base + "/doc/vdoc/ops", data=body))

        codes = []
        for kind, pos, extra in (("ins", 999, {"content": "X"}),
                                 ("ins", -1, {"content": "X"}),
                                 ("ins", 0, {"content": ""}),
                                 ("del", 3, {"len": 99}),
                                 ("del", 0, {"len": 0}),
                                 ("del", -2, {"len": 1})):
            op = {"agent": "evil", "seq": 0, "parents": frontier,
                  "kind": kind, "pos": pos, **extra}
            codes.append(_status(lambda: push(op)))
        out = [codes, ol.checkout_tip().snapshot()]
        push({"agent": "evil", "seq": 0, "parents": frontier,
              "kind": "ins", "pos": 5, "content": "!"})
        push({"agent": "evil", "seq": 1, "parents": [["evil", 0]],
              "kind": "del", "pos": 5, "len": 1})
        return out + [ol.checkout_tip().snapshot()]
    finally:
        _stop(httpd)


def test_crdt_ops_endpoint_rejects_out_of_range():
    assert _both(_crdt_out_of_range) == [[400] * 6, "hello", "hello"]


def _crdt_minimal_frontier(root):
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        a = CrdtPeer(base, "mdoc", "aa")
        a.edit_ins(0, "xy")
        a.sync()
        b = CrdtPeer(base, "mdoc", "bb")
        b.sync()
        b.edit_ins(2, "z")
        b.sync()
        body = json.dumps({"have": {}, "push": [
            {"agent": "cc", "seq": 0, "parents": [["aa", 1], ["bb", 0]],
             "kind": "ins", "pos": 3, "content": "!"}]}).encode("utf8")
        urllib.request.urlopen(urllib.request.Request(
            base + "/doc/mdoc/ops", data=body))
        ol = httpd.RequestHandlerClass.store.get("mdoc")
        lv = ol.cg.remote_to_local_frontier([("cc", 0)])[0]
        return [list(ol.cg.graph.parents_at(lv)) ==
                list(ol.cg.remote_to_local_frontier([("bb", 0)])),
                ol.checkout_tip().snapshot()]
    finally:
        _stop(httpd)


def test_crdt_ops_minimal_frontier_stored():
    assert _both(_crdt_minimal_frontier) == [True, "xyz!"]


def _crdt_surrogates(root):
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        def push(op):
            body = json.dumps({"push": [op]}).encode("utf8", "surrogatepass")
            return urllib.request.urlopen(urllib.request.Request(
                base + "/doc/s/ops", data=body))

        push({"agent": "ok", "seq": 0, "parents": [], "kind": "ins",
              "pos": 0, "content": "hi"})
        codes = [_status(lambda: push(op)) for op in (
            {"agent": "evil", "seq": 0, "parents": [["ok", 1]],
             "kind": "ins", "pos": 0, "content": "\ud800"},
            {"agent": "ev\udfffil", "seq": 0, "parents": [["ok", 1]],
             "kind": "ins", "pos": 0, "content": "x"})]
        ol = httpd.RequestHandlerClass.store.get("s")
        enc = _mod(root, "encoding.encode")
        return [codes, len(enc.encode_oplog(ol, enc.ENCODE_FULL)) > 0,
                ol.checkout_tip().snapshot()]
    finally:
        _stop(httpd)


def test_crdt_ops_rejects_lone_surrogates():
    assert _both(_crdt_surrogates) == [[400, 400], True, "hi"]


def _astral_dumb(root, tmp_path):
    httpd, base = _serve(root, port=0, data_dir=str(tmp_path / root))
    try:
        w1 = DumbClient(root, base, "astro", "web-one")
        w1.edit([{"kind": "ins", "pos": 0,
                  "text": "a\U0001F600b\U0001F3F4c"}])
        w2 = DumbClient(root, base, "astro", "web-two")
        w2.sync()
        out = [w2.text]
        w2.edit([{"kind": "ins", "pos": 4, "text": "!"}])
        w1.edit([{"kind": "del", "start": 1, "end": 2}])
        w1.sync()
        w2.sync()
        w1.sync()
        return out + [w1.text, w2.text]
    finally:
        _stop(httpd)


def test_dumb_client_astral_positions(tmp_path):
    assert _both(_astral_dumb, tmp_path) == [
        "a\U0001F600b\U0001F3F4c", "ab\U0001F3F4!c", "ab\U0001F3F4!c"]


def _astral_crdt(root):
    httpd, base = _serve(root, port=0, data_dir=None)
    try:
        p1 = CrdtPeer(base, "adoc", "anna")
        p1.edit_ins(0, "x\U0001F600y")
        p1.sync()
        p2 = CrdtPeer(base, "adoc", "bert")
        out = [_units(p2.sync()), p2.known["anna"]]
        p2.edit_ins(2, "\U0001F3F4")
        p2.sync()
        p1.sync()
        return out + [httpd.RequestHandlerClass.store.get("adoc")
                      .checkout_tip().snapshot()]
    finally:
        _stop(httpd)


def test_crdt_peer_astral_unit_ops():
    assert _both(_astral_crdt) == [3, 3, "x\U0001F600\U0001F3F4y"]


# ---- the device scheduler behind the server ------------------------------------

def _sharded_server(root, tmp_path):
    """`serve(serve_shards=2)`: JAX's host-engine scheduler, the port's
    fused device engine with the device plan (on the CPU here). Edits from
    two clients merge through the scheduler and `/metrics` reports them."""
    SyncClient = _mod(root, "tools.server").SyncClient
    httpd, base = _serve(root, port=0, data_dir=str(tmp_path / root),
                         serve_shards=2)
    try:
        sched = httpd.store.scheduler
        texts = []
        for k in range(4):
            a = SyncClient(base, f"sd{k}", "alice")
            b = SyncClient(base, f"sd{k}", "bob")
            a.insert(0, f"doc {k} by alice. ")
            a.sync()
            b.pull()
            b.insert(len(b.text()), "bob was here")
            a.insert(0, ">> ")
            a.sync()
            b.sync()
            a.sync()
            texts.append(a.text())
        sched.drain()
        m = json.loads(_get(base + "/metrics"))["serve"]
        return {"texts": texts,
                "sched": [sched.text(f"sd{k}") for k in range(4)],
                "submits": m["totals"]["submits"],
                "host_fallbacks": m["totals"]["host_fallbacks"],
                "engine": getattr(sched.banks[0], "engine", None),
                "device_plan": bool(getattr(sched, "device_plan", False))}
    finally:
        _stop(httpd)


def test_sharded_server_merges_through_the_scheduler(tmp_path):
    runs = {r: _sharded_server(r, tmp_path) for r in ROOTS}
    for key in ("texts", "sched", "submits", "host_fallbacks"):
        assert runs[PORT][key] == runs[JAX][key], key
    assert runs[PORT]["texts"] == runs[PORT]["sched"]
    assert runs[PORT]["host_fallbacks"] == 0 and runs[PORT]["submits"] >= 8
    # the divergence: the port's server merges on the device engine with
    # the device plan, JAX's on the host engine
    assert runs[PORT]["engine"] == "device" and runs[PORT]["device_plan"]
    assert runs[JAX]["engine"] == "host" and not runs[JAX]["device_plan"]


# ---- deliberate divergences -------------------------------------------------------

def test_sharded_serve_without_cuda_or_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    srv = _mod(PORT, "tools.server")
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.serve(port=0, data_dir=str(tmp_path), serve_shards=2)
    # nothing was started or written: the raise comes before the store
    assert list(tmp_path.iterdir()) == []
    # without shards nothing touches the device
    httpd = srv.serve(port=0)
    try:
        assert httpd.store.scheduler is None and httpd.store.device is None
    finally:
        httpd.server_close()


def test_device_history_strip_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    srv = _mod(PORT, "tools.server")
    ol = _concurrent_oplog(PORT)
    monkeypatch.setenv("DT_SERVER_DEVICE", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.doc_history_strip(ol, 8)
    assert srv.doc_history_strip(ol, 8, device="cpu")[-1]["text"] == \
        ol.checkout_tip().snapshot()
    # a server without a device answers the device strip with no result:
    # the handler's fault is not turned into a host strip
    httpd, base = _serve(PORT, port=0, device=None)
    try:
        enc = _mod(PORT, "encoding.encode")
        urllib.request.urlopen(urllib.request.Request(
            base + "/doc/h/push",
            data=enc.encode_oplog(ol, enc.ENCODE_FULL))).read()
        with pytest.raises(OSError):
            urllib.request.urlopen(urllib.request.Request(
                base + "/doc/h/history", data=b'{"n": 8}'), timeout=10)
    finally:
        _stop(httpd)


def test_follower_reads_raise_import_error_until_read_is_ported():
    srv = _mod(PORT, "tools.server")
    with pytest.raises(ImportError):
        srv.serve(port=0, follower_reads=True)


# ---- on the card ------------------------------------------------------------------

def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_device_history_strip_equals_host_strip_on_cuda(monkeypatch):
    """The DT_SERVER_DEVICE strip (one K3 launch) equals the same strip
    on the CPU (K3's plain version), and its merged tip the host's."""
    _needs_cuda()
    from diamond_types_tpu_torch.gpu import kernels
    srv = _mod(PORT, "tools.server")
    from torch_parity import TwinDocs
    ol = _mod(PORT, "text.oplog").OpLog()
    twins = TwinDocs([ol], seed=7, alphabet="abc中😀 ")
    twins.type_base("alice", 200)
    for r in range(3):
        twins.fork(["alice", "bob"])
        twins.edits("alice", 8)
        twins.edits("bob", 8)
        twins.merge_tip("alice")
    monkeypatch.setenv("DT_SERVER_DEVICE", "1")
    kernels.materialize_runs.launches = 0
    dev = srv.doc_history_strip(ol, 16)
    assert kernels.materialize_runs.launches == 1
    cpu = srv.doc_history_strip(ol, 16, device="cpu")
    assert dev == cpu and dev[-1]["text"] == ol.checkout_tip().snapshot()


@pytest.mark.cuda
def test_two_node_port_mesh_converges_on_cuda():
    """Two port servers merging on the card behind the admit gate: writes
    at either node converge, each doc merged on its owner only, whose
    scheduler serves the converged text from its device session: the
    session is resident and caught up with the oplog, its rows read on
    the card equal the text, and K1 replayed the second round's tails."""
    _needs_cuda()
    from diamond_types_tpu_torch.gpu import kernels
    from diamond_types_tpu_torch.replicate import attach_replication
    srv = _mod(PORT, "tools.server")
    httpds = [srv.serve(port=0, serve_shards=2) for _ in range(2)]
    addrs = [f"127.0.0.1:{h.server_address[1]}" for h in httpds]
    try:
        nodes = [attach_replication(h, addrs[i],
                                    [a for a in addrs if a != addrs[i]],
                                    backoff_base_s=0.01, backoff_cap_s=0.05)
                 for i, h in enumerate(httpds)]
        for h in httpds:
            threading.Thread(target=h.serve_forever, daemon=True).start()
        kernels.apply_ops_window.launches = 0
        docs = [f"cuda-{k}" for k in range(6)]
        # two rounds: the first builds each owner's session, the second's
        # tails replay on it (K1)
        for rnd in range(2):
            for k, d in enumerate(docs):
                for i in range(2):
                    c = srv.SyncClient(f"http://{addrs[i]}", d, f"w{i}")
                    c.pull()
                    c.insert(len(c.text()), f"[{rnd}:{i}:{k}]" * 20)
                    c.sync()
            for h in httpds:
                h.store.scheduler.drain()
        for _ in range(20):
            for n in nodes:
                n.table.probe_once()
                n.maintain()
            for n in nodes:
                n.antientropy.run_round()
            texts = [{_get(f"http://{a}/doc/{d}") for a in addrs}
                     for d in docs]
            if all(len(t) == 1 for t in texts):
                break
        for d, t in zip(docs, texts):
            assert len(t) == 1
            owner = next(n for n in nodes if n.owns(d))
            assert [n.self_id for n in nodes if d in n.merged_docs] == \
                [owner.self_id]
            sched = owner.store.scheduler
            sched.drain()
            want = t.pop()
            sess = sched.banks[sched.router.shard_of(d)].sessions.get(d)
            with owner.store.lock:
                assert sess is not None
                assert sess.synced_to == len(owner.store.docs[d])
            assert sess.text() == want
            assert sched.text(d) == want
        assert kernels.apply_ops_window.launches > 0
        assert all(h.store.scheduler.metrics_json()["totals"]
                   ["host_fallbacks"] == 0 for h in httpds)
        assert sum(h.store.scheduler.metrics_json()["totals"]["denied"]
                   for h in httpds) > 0
    finally:
        for h in httpds:
            _stop(h)
