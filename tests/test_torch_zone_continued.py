"""The zone session's continued sync against the plain reference.

A `DeviceZoneSession` continues its resident carry with one micro-tape a
sync. The benchmark's concurrent mix (`dtbench/traffic/concurrent.json`:
two agents forked from the merged version, then one op on both tips) is
fed to a port session on the CPU, where X8's plain version runs, and every
sync's text is held against the benchmark's plain reference
(`dtbench/reference/listcrdt.py`) and the op log's own checkout.

The witness is document 5 of seed 77 at `python3 -m dtbench.zone_repro`'s
sizes (bases of 200-400 chars): bob's entry of sync 6 holds a block of
310 chars whose root run is its last, since bob typed each later run to
the left of the one before. The block spans two APPLY sub-steps, so its
first chunk is placed before the root's own sub-step writes the root's
keys. The port writes every new slot's keys into the carry before the
tape runs; the JAX session does not, and serves text that differs from
the reference there. That divergence is pinned here with both outputs.
"""

import hashlib
import json
from pathlib import Path

import pytest

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu.zone_session import (RESYNC_CAUSES,
                                                      DeviceZoneSession)
from dtbench.reference.listcrdt import RefDoc
from dtbench.tiers import add_op, append_sync
from dtbench.traffic.generate import DocGen

REPO = Path(__file__).resolve().parent.parent
WITNESS = (77, 5)          # seed, document
CPU = {"device": "cpu"}


def _mix():
    mix = json.loads((REPO / "dtbench" / "traffic" / "concurrent.json")
                     .read_text())
    mix["docs"].update(base_min=200, base_max=400)    # zone_repro's sizes
    return mix


class Doc:
    """One generated document in an op log of `oplog_cls`, with the
    reference replaying the same syncs."""

    def __init__(self, seed, index, oplog_cls=OpLog):
        mix = _mix()
        self.gen = DocGen(seed, index, mix["docs"], mix["edits"])
        self.ol = oplog_cls()
        self.ids = {a: self.ol.get_or_create_agent_id(a)
                    for a in self.gen.agents()}
        self.ref = RefDoc()
        self.tip = []
        self.k = -1

    def next_sync(self) -> dict:
        self.k += 1
        if self.k == 0:
            return self.gen.syncs[0]
        sync = self.gen.next_sync()
        self.gen.syncs.append(sync)
        return sync

    def append(self, sync) -> None:
        self.tip = append_sync(self.ol, self.ids, self.tip, sync)
        self.ref.apply_sync(sync)

    def through(self, k: int) -> "Doc":
        while self.k < k:
            self.append(self.next_sync())
        return self

    def entries(self, sync):
        """The sync's ops one entry at a time: yields after each chain
        with the frontier of the chains so far, then after the top op
        with the new tip."""
        tips = []
        for agent, ops in sync["chains"]:
            parents = self.tip
            for op in ops:
                parents = [add_op(self.ol, self.ids[agent], parents, op)]
            tips.extend(parents)
            yield sorted(tips)
        agent, op = sync["top"]
        self.tip = [add_op(self.ol, self.ids[agent], sorted(tips), op)]
        self.ref.apply_sync(sync)
        yield self.tip


def _first_diff(a: str, b: str) -> int:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def test_witness_continued_sync_matches_reference():
    """Sync 6 of the witness, entry by entry, on a session built at sync
    5: alice's entry, bob's (concurrent with alice's, forked from the same
    tip row) and the top op each equal the op log's checkout at their
    frontier, the last the reference too; each is a continued sync with
    one launch, and the session never resyncs."""
    doc = Doc(*WITNESS).through(5)
    assert len(doc.ol) == 9081
    sess = DeviceZoneSession(doc.ol, **CPU)
    assert sess.row_of == {(9080,): 2, (8076,): 0, (9035,): 1}
    sess.take_counts()
    sync = doc.next_sync()
    spans = []
    for frontier in doc.entries(sync):
        lv0 = sess.synced_to
        assert sess.sync() > 0
        spans.append((lv0, len(doc.ol)))
        want = doc.ol.checkout(frontier).snapshot()
        assert sess.text() == want, (frontier, _first_diff(sess.text(),
                                                           want))
    assert spans[:2] == [(9081, 10237), (10237, 11856)]
    assert sess.text() == doc.ref.text() == doc.ol.checkout_tip().snapshot()
    assert len(doc.ol) == 11881
    counts = sess.take_counts()
    assert sess.resyncs == 0
    assert (counts["syncs"], counts["continued"], counts["resynced"],
            counts["launches"]) == (3, 3, 0, 3)


def test_witness_sync_in_one_tape_matches_reference():
    """The witness's sync 6 as the benchmark's tier sends it, the three
    entries in one micro-tape: one continued sync, one launch, the
    reference's text."""
    doc = Doc(*WITNESS).through(5)
    sess = DeviceZoneSession(doc.ol, **CPU)
    sess.take_counts()
    doc.append(doc.next_sync())
    sess.sync()
    assert sess.text() == doc.ref.text()
    counts = sess.take_counts()
    assert (counts["continued"], counts["resynced"], counts["launches"]) \
        == (1, 0, 1)


def test_jax_session_serves_the_witness_wrongly():
    """The divergence: the JAX package's session, fed the same op log, gets
    alice's entry right and bob's wrong, with the reference's length and
    the first difference at offset 1,310 (bob's run before alice's
    concurrent one where the YjsMod order puts alice first); after the top
    op it still differs from the reference, where the port's session
    equals it (the test above)."""
    from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
    from diamond_types_tpu.tpu.zone_session import \
        DeviceZoneSession as JaxSession

    doc = Doc(*WITNESS, oplog_cls=JaxOpLog).through(5)
    sess = JaxSession(doc.ol)
    sync = doc.next_sync()
    got = []
    for frontier in doc.entries(sync):
        sess.sync()
        got.append((sess.text(), doc.ol.checkout(frontier).snapshot()))
    (alice, alice_want), (bob, bob_want), (top, top_want) = got
    assert alice == alice_want
    assert bob != bob_want and len(bob) == len(bob_want) == 3384
    assert _first_diff(bob, bob_want) == 1310
    assert top != doc.ref.text() and len(top) == len(doc.ref.text())
    assert top_want == doc.ref.text()
    assert sess.resyncs == 0
    assert hashlib.sha1(top.encode()).hexdigest() == JAX_WITNESS_SHA1


# the JAX session's text after the witness's sync 6, entry by entry
JAX_WITNESS_SHA1 = "996ec8e105e54770aac1ed41c18ff2e0e12f2289"


CASES = [(77, 2), (77, 5), (1, 0), (3, 4), (4100000007, 1)]


@pytest.mark.parametrize("seed,index", CASES)
def test_every_sync_is_continued_and_matches_reference(seed, index):
    """A document through 12 syncs of the concurrent mix, the session
    built at the base and wide enough for all of them (a sync allocates
    about 1,000 slots; the base has 200-400): every sync is a continued
    one (one launch, no resync) and its text is the reference's."""
    doc = Doc(seed, index).through(0)
    sess = DeviceZoneSession(doc.ol, headroom=64.0, **CPU)
    sess.take_counts()
    for k in range(1, 13):
        doc.append(doc.next_sync())
        sess.sync()
        assert sess.text() == doc.ref.text(), k
    counts = sess.take_counts()
    assert (counts["syncs"], counts["continued"], counts["launches"]) \
        == (12, 12, 12)
    assert sess.resyncs == 0


@pytest.mark.parametrize("seed,index", [(77, 2), (3, 4)])
def test_default_width_resyncs_only_for_capacity(seed, index):
    """At the session's default headroom the same documents outgrow their
    slots: those syncs rebuild (counted under slot_capacity, one launch
    each), every other stays continued, and every text is the
    reference's."""
    doc = Doc(seed, index).through(0)
    sess = DeviceZoneSession(doc.ol, **CPU)
    sess.take_counts()
    for k in range(1, 13):
        doc.append(doc.next_sync())
        sess.sync()
        assert sess.text() == doc.ref.text(), k
    counts = sess.take_counts()
    assert counts["syncs"] == 12 == counts["continued"] + counts["resynced"]
    assert 0 < counts["resynced"] == counts["resync_slot_capacity"] \
        == sum(counts[f"resync_{c}"] for c in RESYNC_CAUSES) \
        == sess.resyncs
    assert counts["launches"] == 12
