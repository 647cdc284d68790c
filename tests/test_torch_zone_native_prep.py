"""The zone session's continued-sync micro-tape, built in C++.

A continued sync's tape is composed by the native composer
(`dt_compose_plan`) and packed by the native zone packer (`dt_zone_pack`)
on the session's own scratch context (`native.core.MicroTapeContext`),
and by the Python composer, `entry_steps` and `_fill_tape` when the native
engine is off or refuses the input. Both must give the same tape, column
for column, so X8 runs the same steps on the same carry.

The traffic is the benchmark's concurrent mix
(`dtbench/traffic/concurrent.json`) at bases of 200 to 2,000 chars, and
the continued-sync witness (document 5 of seed 77 at
`python3 -m dtbench.zone_repro`'s sizes, `test_torch_zone_continued.py`).
On every sync the native tape is held against the Python one built from
the same state, and the session's text against the plain reference
(`dtbench/reference/listcrdt.py`). Sessions live on the CPU, where X8's
plain version runs; the `cuda` case runs the same on a card.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import zone_session as zs
from diamond_types_tpu_torch.gpu.zone_kernel import ZoneTape
from diamond_types_tpu_torch.listmerge import plan2
from diamond_types_tpu_torch.native import native_enabled
from diamond_types_tpu_torch.native.core import MicroTapeContext
from diamond_types_tpu_torch.text.op import INS
from dtbench import metrics
from dtbench.reference.listcrdt import RefDoc
from dtbench.tiers import append_sync
from dtbench.traffic.generate import DocGen

from test_torch_zone_continued import WITNESS, Doc

REPO = Path(__file__).resolve().parent.parent
COLUMNS = tuple(f.name for f in dataclasses.fields(ZoneTape))
CONTINUED = 12           # continued syncs a document, at least
# (seed, document, largest base in chars); the first is the witness's
CASES = [(77, 5, 400), (2100000011, 0, 2000), (7, 1, 1200),
         (3000000019, 2, 800)]


@pytest.fixture(autouse=True)
def one_thread():
    """X8's plain version is thousands of small torch calls a sync: one
    intra-op thread runs them as fast, and leaves the cores of the other
    test workers alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stream:
    """One generated document of the concurrent mix, its op log and the
    reference, fed one whole sync at a time."""

    def __init__(self, seed, index, base_max):
        mix = json.loads((REPO / "dtbench" / "traffic" / "concurrent.json")
                         .read_text())
        mix["docs"].update(base_min=200, base_max=base_max)
        self.gen = DocGen(seed, index, mix["docs"], mix["edits"])
        self.ol = OpLog()
        self.ids = {a: self.ol.get_or_create_agent_id(a)
                    for a in self.gen.agents()}
        self.ref = RefDoc()
        self.tip = []
        self._append(self.gen.syncs[0])

    def _append(self, sync) -> None:
        self.tip = append_sync(self.ol, self.ids, self.tip, sync)
        self.ref.apply_sync(sync)

    def next(self) -> None:
        sync = self.gen.next_sync()
        self.gen.syncs.append(sync)
        self._append(sync)


def _run(case, device="cpu"):
    """Sync the session after every generated sync until CONTINUED of them
    continued the carry; every text equals the reference's. Returns the
    texts and the counters of each sync."""
    doc = Stream(*case)
    sess = zs.DeviceZoneSession(doc.ol, device=device)
    sess.take_counts()
    texts, counts = [], []
    while sum(c["continued"] for c in counts) < CONTINUED:
        assert len(counts) < 3 * CONTINUED, "the session keeps resyncing"
        doc.next()
        sess.sync()
        texts.append(sess.text())
        counts.append(sess.take_counts())
        assert texts[-1] == doc.ref.text(), (case, len(texts))
    return texts, counts


def _tapes_equal(got: ZoneTape, want: ZoneTape) -> None:
    for name in COLUMNS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.fixture
def compared(monkeypatch):
    """Every native micro-tape is held against the Python path's tape built
    from the same session state; the count of tapes compared."""
    real = zs.DeviceZoneSession._native_tape
    seen = []

    def spy(self, entries, pieces, runs0):
        tape = real(self, entries, pieces, runs0)
        assert tape is not None
        _tapes_equal(tape, self._python_tape(entries))
        seen.append(tape.total_steps)
        return tape

    monkeypatch.setattr(zs.DeviceZoneSession, "_native_tape", spy)
    return seen


def _need_native():
    if not native_enabled():
        pytest.skip("the native library cannot be built here")


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_native_tape_equals_the_python_tape(case, compared):
    """On every continued sync the C++ micro-tape equals the Python path's
    column for column, the sync counts `prep_native` and not
    `prep_python`, and the text is the reference's."""
    _need_native()
    _texts, counts = _run(case)
    continued = sum(c["continued"] for c in counts)
    assert len(compared) == continued >= CONTINUED
    for c in counts:
        assert (c["prep_native"], c["prep_python"]) == (c["continued"], 0)
        assert c["syncs"] == 1


def test_witness_sync_is_packed_natively(compared):
    """The witness's sync 6 on a session built at sync 5, its three
    entries in one micro-tape: built in C++, equal to the Python tape, and
    the reference's text."""
    _need_native()
    doc = Doc(*WITNESS).through(5)
    sess = zs.DeviceZoneSession(doc.ol, device="cpu")
    sess.take_counts()
    doc.append(doc.next_sync())
    sess.sync()
    assert sess.text() == doc.ref.text()
    c = sess.take_counts()
    assert (c["continued"], c["prep_native"], c["prep_python"]) == (1, 1, 0)
    assert len(compared) == 1


@pytest.mark.parametrize("case", CASES[:2],
                         ids=lambda c: "-".join(map(str, c)))
def test_without_native_the_python_path_gives_the_same_texts(case,
                                                             monkeypatch):
    """With the native engine off (DT_TPU_NO_NATIVE), the same syncs give
    the same texts as with it (the reference's, `_run` checks, as the
    native run's are), every continued sync counted as `prep_python`."""
    _need_native()
    monkeypatch.setenv("DT_TPU_NO_NATIVE", "1")
    _texts, counts = _run(case)
    for c in counts:
        assert (c["prep_native"], c["prep_python"]) == (0, c["continued"])


def test_a_refused_pack_falls_back_to_python(monkeypatch):
    """When `MicroTapeContext.pack` gives None (the C++ refused the
    entries), the sync's tape comes from the Python path, counted as
    `prep_python`, and the text is the reference's."""
    _need_native()
    monkeypatch.setattr(MicroTapeContext, "pack", lambda *a, **k: None)
    doc = Stream(*CASES[0])
    sess = zs.DeviceZoneSession(doc.ol, device="cpu")
    sess.take_counts()
    for _k in range(3):
        doc.next()
        sess.sync()
        assert sess.text() == doc.ref.text()
    c = sess.take_counts()
    assert c["continued"] > 0
    assert (c["prep_native"], c["prep_python"]) == (0, c["continued"])


def _next_seq(ol, agent: int) -> int:
    return max(s + (e - b) for b, e, a, s in
               ol.cg.agent_assignment.global_runs if a == agent)


def test_a_reverse_insert_run_is_refused_by_both_composers():
    """An insert run typed backwards (fwd False, as a decoded file can
    carry): the C++ composer refuses it (`dt_compose_plan` -1), the sync
    counts `prep_python`, and the Python composer refuses it too, as it
    did before the native path."""
    _need_native()
    doc = Stream(*CASES[1])
    sess = zs.DeviceZoneSession(doc.ol, device="cpu")
    doc.next()
    sess.sync()
    sess.take_counts()
    ol, agent = doc.ol, doc.ids["typist"]
    at = len(sess.text()) // 2
    ol.add_remote_op(agent, _next_seq(ol, agent), list(ol.version), INS, at,
                     at + 3, False, "xyz")
    assert not ol.ops.runs[-1].fwd
    with pytest.raises(AssertionError, match="reverse insert runs"):
        sess.sync()
    c = sess.take_counts()
    assert (c["prep_native"], c["prep_python"]) == (0, 1)


def test_the_scratch_context_packs_on_after_a_refusal(compared):
    """The session's scratch context, after the C++ really refused a
    reverse insert run on it and after a compose behind the session's
    back, still packs every later sync natively: the pack reads the
    compose cache's serial from the C++, so the two cannot drift apart."""
    _need_native()
    doc = Stream(*CASES[1])
    sess = zs.DeviceZoneSession(doc.ol, device="cpu")
    sess.take_counts()
    counts = []
    while sum(c["continued"] for c in counts) < 4:
        assert len(counts) < 12, "the session keeps resyncing"
        ctx = sess._micro
        if ctx is not None:
            assert ctx.pack([(0, INS, False, 0, 3)], [(0, 3)],
                            [(plan2.APPLY, 0, 0)], [0], [0], sess.plen,
                            sess.agent_k, sess.seq_k, sess.MB, sess.MC,
                            sess.MD) is None
            assert ctx._lib.dt_compose_plan(ctx._ptr, 0, None, None) == 0
        doc.next()
        sess.sync()
        assert sess.text() == doc.ref.text()
        counts.append(sess.take_counts())
    for c in counts:
        assert (c["prep_native"], c["prep_python"]) == (c["continued"], 0)
    assert len(compared) == 4


def test_a_sync_of_many_runs(compared):
    """One continued sync of 600 op runs (a typist's scattered inserts
    and deletes, each its own run): every run is loaded into the scratch
    context, and the tape equals the Python one and the text the op log's
    own checkout."""
    _need_native()
    doc = Stream(*CASES[1])
    sess = zs.DeviceZoneSession(doc.ol, device="cpu")
    sess.take_counts()
    ol, agent = doc.ol, doc.ids["typist"]
    runs0 = len(ol.ops.runs)
    n = len(sess.text())
    for i in range(600):
        at = (i * 7919) % n
        if i % 3 == 2:
            ol.add_delete_without_content(agent, at, at + 1)
            n -= 1
        else:
            ol.add_insert(agent, at, "xy"[i % 2])
            n += 1
    assert len(ol.ops.runs) - runs0 == 600
    sess.sync()
    c = sess.take_counts()
    assert (c["continued"], c["prep_native"], c["prep_python"]) == (1, 1, 0)
    assert len(compared) == 1
    assert sess.text() == ol.checkout_tip().snapshot()


def test_new_slots_keys_are_the_tapes():
    """The key arrays `_write_keys` uploads hold, for every slot a
    continued sync allocates, the keys its tape places there."""
    _need_native()
    doc = Stream(*CASES[0])
    sess = zs.DeviceZoneSession(doc.ol, device="cpu")
    tapes = []
    real = sess._micro_tape

    def keep(*args):
        tapes.append(real(*args))
        return tapes[-1]

    sess._micro_tape = keep
    checked = 0
    for _k in range(4):
        w0 = sess.W_used
        doc.next()
        sess.sync()
        if tapes:               # a continued sync
            tape = tapes.pop()
            slots = tape.ch_slot.ravel()
            new = slots >= w0
            assert np.unique(slots[new]).tolist() == \
                list(range(w0, sess.W_used))
            assert (sess.agent_k[slots[new]] == tape.ch_agent.ravel()[new]) \
                .all()
            assert (sess.seq_k[slots[new]] == tape.ch_seq.ravel()[new]).all()
            checked += 1
    assert checked > 0


@pytest.mark.cuda
def test_native_tape_on_the_card(compared):
    """The witness and one large document on a card: the tapes equal the
    Python path's and the texts the reference's on every sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: X8 has no interpret mode")
    _need_native()
    for case in CASES[:2]:
        _texts, counts = _run(case, device="cuda")
        assert all(c["prep_native"] == c["continued"] for c in counts)
    assert len(compared) >= 2 * CONTINUED


def _zone(**kw):
    z = dict.fromkeys(zs.ZONE_COUNTS, 0)
    z.update(kw)
    return z


def _ctx(before, after):
    snaps = [{"totals": {}} if z is None else {"totals": {}, "zone": z}
             for z in (before, after)]
    return {"sched_before": snaps[0], "sched_after": snaps[1]}


def test_zone_native_prep_pct_reads_the_windows_counters():
    """The reader: prep_native over both counters in the window's delta;
    None from a program without the counters (the parent of this metric)
    or with no continued sync in the window."""
    read = metrics.load("zone_native_prep_pct")
    ctx = _ctx(_zone(prep_native=10, prep_python=2),
               _zone(prep_native=40, prep_python=12))
    assert read(ctx) == pytest.approx(75.0)
    assert read(_ctx(_zone(prep_native=3), _zone(prep_native=9))) == 100.0
    assert read(_ctx(None, None)) is None
    old = {k: 0 for k in zs.ZONE_COUNTS if not k.startswith("prep_")}
    assert read(_ctx(old, dict(old, syncs=5))) is None
    assert read(_ctx(_zone(prep_native=3), _zone(prep_native=3))) is None
