"""The port's native local ingest (`native/ingest.py`, `OpLog.local_session`)
and trace replays (`text/trace.py`) against the JAX package's.

Random linear edit scripts run through the port's native `LocalSession`
(its own build of `native/dt_ingest.cpp` under `_build/`), its Python
`PySession` (the kill switch `DT_TPU_NO_NATIVE`), and the JAX package's
per-op path and native session: the op runs and the encoded bytes must be
identical. Generated editing traces (the corpus traces are not in the
repo) replay through every `replay_into_oplog*` of both packages to the
same bytes and to `replay_direct`'s text.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from diamond_types_tpu.encoding.encode import encode_oplog as jencode
from diamond_types_tpu.native import ingest as jingest
from diamond_types_tpu.text import trace as jtrace
from diamond_types_tpu.text.oplog import OpLog as JOpLog
from diamond_types_tpu_torch.encoding.encode import encode_oplog as tencode
from diamond_types_tpu_torch.native import build as tbuild
from diamond_types_tpu_torch.native import ingest as tingest
from diamond_types_tpu_torch.text import trace as ttrace
from diamond_types_tpu_torch.text.oplog import OpLog as TOpLog
from tests.test_native_ingest import _random_script

REPO = Path(__file__).resolve().parent.parent


def _runs(ol):
    return [(r.lv, r.kind, r.start, r.end, r.fwd, r.content_pos)
            for r in ol.ops.runs]


def _per_op(make, script):
    ol = make()
    ag = ol.get_or_create_agent_id("t")
    for op in script:
        if op[0] == "i":
            ol.add_insert(ag, op[1], op[2])
        elif op[0] == "d":
            ol.add_delete_without_content(ag, op[1], op[2])
        else:
            ol.add_delete_at(ag, ol.version, op[1], op[2], op[3])
    return ol


def _session(make, script, flush_every=None):
    ol = make()
    ag = ol.get_or_create_agent_id("t")
    s = ol.local_session(ag)
    lvs = []
    for k, op in enumerate(script):
        if op[0] == "i":
            lvs.append(s.insert(op[1], op[2]))
        elif op[0] == "d":
            lvs.append(s.delete(op[1], op[2]))
        else:
            lvs.append(s.delete(op[1], op[2], op[3]))
        if flush_every and (k + 1) % flush_every == 0:
            s.flush()
    s.flush()
    return ol, lvs, type(s).__name__


def test_the_port_builds_its_own_ingest_extension():
    assert tingest.native_ingest_available()
    path = Path(tbuild.build_ingest())
    assert path.parent == REPO / "diamond_types_tpu_torch" / "_build"
    assert path.name.startswith("_dtingest-")
    assert Path(tingest._ext.__file__).resolve() == path.resolve()


@pytest.mark.parametrize("flush_every", [None, 1, 7, 100])
@pytest.mark.parametrize("seed", [3, 20260730])
def test_native_session_bytes_match_jax(seed, flush_every):
    script, end = _random_script(random.Random(seed), 800)
    jol = _per_op(JOpLog, script)
    tol, tlvs, kind = _session(TOpLog, script, flush_every)
    assert kind == "LocalSession"
    jses, jlvs, _ = _session(JOpLog, script, flush_every)
    assert tlvs == jlvs
    assert _runs(tol) == _runs(jol) == _runs(jses)
    assert tencode(tol) == jencode(jol) == jencode(jses)
    assert tol.checkout_tip().snapshot() == end


@pytest.mark.parametrize("seed", [5, 6])
def test_python_session_under_the_kill_switch_matches_jax(seed,
                                                          monkeypatch):
    script, end = _random_script(random.Random(seed), 400)
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    assert not tingest.native_ingest_available()
    tol, tlvs, kind = _session(TOpLog, script)
    assert kind == "PySession"
    monkeypatch.delenv("DT_TPU_NO_NATIVE")
    jol, jlvs, _ = _session(JOpLog, script)
    assert tlvs == jlvs
    assert _runs(tol) == _runs(jol)
    assert tencode(tol) == jencode(jol)
    assert tol.checkout_tip().snapshot() == end


def test_kill_switch_in_a_fresh_process():
    """DT_TPU_NO_NATIVE makes `local_session()` native-free from the first
    call: the extension is neither built nor loaded."""
    code = (
        "from diamond_types_tpu_torch.text.oplog import OpLog\n"
        "from diamond_types_tpu_torch.native import ingest\n"
        "ol = OpLog(); ag = ol.get_or_create_agent_id('t')\n"
        "s = ol.local_session(ag)\n"
        "assert isinstance(s, ingest.PySession), type(s)\n"
        "with s:\n"
        "    s.insert(0, 'fallback')\n"
        "    s.delete(0, 1, 'f')\n"
        "assert ol.checkout_tip().snapshot() == 'allback'\n"
        "assert ingest._ext is False\n"
        "assert '_dtingest' not in open('/proc/self/maps').read()\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, DT_TPU_NO_NATIVE="1"))
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-500:]


def test_failed_ingest_build_means_no_library(tmp_path, monkeypatch,
                                              capsys):
    bad = tmp_path / "dt_ingest.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "SOURCE_INGEST", bad)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "_build")
    assert tbuild.build_ingest() is None
    assert "ingest ext build failed" in capsys.readouterr().err
    assert not list((tmp_path / "_build").glob("_dtingest-*"))
    monkeypatch.setattr(tbuild, "SOURCE_INGEST", tmp_path / "missing.cpp")
    assert tbuild.build_ingest() is None


def test_session_refuses_a_mutated_oplog_like_jax():
    outs = []
    for make in (JOpLog, TOpLog):
        ol = make()
        ag = ol.get_or_create_agent_id("t")
        s = ol.local_session(ag)
        s.insert(0, "abc")
        ol.add_insert(ag, 0, "x")        # behind the session's back
        with pytest.raises(RuntimeError, match="mutated") as ei:
            s.flush()
        outs.append((str(ei.value), s.pending()))
    assert outs[0] == outs[1]


# ---- trace replays ------------------------------------------------------------

def _trace(mod, seed: int, n_txns: int = 150):
    """A generated editing trace in the corpus format: transactions of
    (pos, num_deleted, inserted) patches over a document starting empty,
    and its end content."""
    rng = random.Random(seed)
    doc = ""
    txns = []
    for _ in range(n_txns):
        txn = []
        for _ in range(rng.randint(1, 3)):
            pos = rng.randint(0, len(doc))
            nd = rng.randint(0, min(6, len(doc) - pos)) \
                if rng.random() < 0.4 else 0
            ins = "".join(rng.choice("abc é😀中\n")
                          for _ in range(rng.randint(0 if nd else 1, 5)))
            txn.append((pos, nd, ins))
            doc = doc[:pos] + ins + doc[pos + nd:]
        txns.append(txn)
    return mod.TestData(start_content="", end_content=doc, txns=txns)


@pytest.mark.parametrize("seed", range(4))
def test_trace_replays_match_jax(seed):
    jd, td = _trace(jtrace, seed), _trace(ttrace, seed)
    assert td.num_ops() == jd.num_ops()
    cols_t, cols_j = td.patch_columns(), jd.patch_columns()
    assert all((a == b).all() for a, b in zip(cols_t[:3], cols_j[:3]))
    assert cols_t[3] == cols_j[3]
    want = jencode(jtrace.replay_into_oplog(jd))
    for fn in ("replay_into_oplog", "replay_into_oplog_native",
               "replay_into_oplog_grouped"):
        tol = getattr(ttrace, fn)(td)
        assert tol.checkout_tip().snapshot() == td.end_content, fn
        assert tencode(tol) == jencode(getattr(jtrace, fn)(jd)), fn
        if fn != "replay_into_oplog_grouped":
            assert tencode(tol) == want, fn
    assert ttrace.replay_direct(td) == jtrace.replay_direct(jd) \
        == td.end_content


def test_trace_native_replay_under_the_kill_switch(monkeypatch):
    td = _trace(ttrace, 9)
    want = tencode(ttrace.replay_into_oplog(td))
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    assert tencode(ttrace.replay_into_oplog_native(td)) == want
    assert jingest.native_ingest_available() is False
