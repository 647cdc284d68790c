"""The check must fail a broken timed path. A CPU run of a small cell with
a fault planted in the program underneath (the harness's look for a card
skipped), and with each control merge in the program's place: `correct`
must come out false. A sound run beside them comes out true."""

import pytest

from conftest import SEED, tiny
from dtbench.reference.listcrdt import CONTROLS
from dtbench.run import run_cell


def run(cell_name="fused-concurrent", **kw):
    cell, config, mix, specs = tiny(cell_name)
    return run_cell(cell, config, mix, specs, SEED, 1.5, False, "cpu", **kw)


def claim_synced(bank, items, resolve):
    """Mark each item's session caught up with its op log, as a flush that
    did the work would have."""
    for it in items:
        sess = bank.sessions.get(it.doc_id)
        if sess is not None:
            sess.synced_to = len(resolve(it.doc_id))


@pytest.fixture
def armed(monkeypatch):
    """Arms a fault in SessionBank.sync_docs once the warm-up is over (the
    first call of Clients.start opens the window)."""
    from diamond_types_tpu_torch.serve.bank import SessionBank
    from dtbench.traffic.clients import Clients
    state = {"on": False}
    real_start = Clients.start

    def start(self, t0, t_end):
        state["on"] = True
        return real_start(self, t0, t_end)

    monkeypatch.setattr(Clients, "start", start)

    def arm(fault):
        real = SessionBank.sync_docs

        def sync_docs(bank, items, resolve, oplog_lock=None,
                      device_lock=None):
            if not state["on"]:
                return real(bank, items, resolve, oplog_lock, device_lock)
            return fault(real, bank, items, resolve, oplog_lock,
                         device_lock)

        monkeypatch.setattr(SessionBank, "sync_docs", sync_docs)
    return arm


def test_sound_run_is_correct():
    assert run()["correct"]


@pytest.mark.parametrize("cell_name", ["fused-concurrent", "fused-typing"])
def test_flush_that_leaves_state_unchanged_fails(armed, cell_name):
    def unchanged(real, bank, items, resolve, ol, dl):
        claim_synced(bank, items, resolve)
        return {"docs": len(items), "fused_calls": 0, "fused_docs": 0,
                "fallback_docs": 0}
    armed(unchanged)
    r = run(cell_name)
    assert not r["correct"]
    assert r["checks"]["mismatched_docs"]["value"] > 0


def test_half_of_a_bucket_left_out_fails(armed):
    def half(real, bank, items, resolve, ol, dl):
        half = len(items) // 2          # a lone item is the half left out
        out = real(bank, items[:half], resolve, ol, dl) if half else \
            {"docs": 0, "fused_calls": 0, "fused_docs": 0, "fallback_docs": 0}
        claim_synced(bank, items[half:], resolve)
        return out
    armed(half)
    r = run()
    assert not r["correct"]


def test_answer_altered_where_it_is_produced_fails(monkeypatch):
    from diamond_types_tpu_torch.gpu.flush_fuse import FusedDocSession
    real = FusedDocSession.text

    def text(self):
        t = real(self)
        return t[:-1] + ("x" if t[-1:] != "x" else "y") if t else "x"

    monkeypatch.setattr(FusedDocSession, "text", text)
    r = run()
    assert not r["correct"]
    assert r["checks"]["mismatched_docs"]["value"] == \
        r["checks"]["checked_docs"]["value"]


def test_lost_commit_fails(monkeypatch):
    """A flush that never reports its commit: the sync is never visible."""
    from dtbench.traffic.clients import Clients
    real = Clients.on_commit
    dropped = []

    def on_commit(self, doc_id):
        if getattr(self, "t_end", None) is not None and not dropped:
            dropped.append(doc_id)
            return
        real(self, doc_id)

    monkeypatch.setattr(Clients, "on_commit", on_commit)
    import dtbench.run
    monkeypatch.setattr(dtbench.run, "DRAIN_S", 2.0)
    r = run()
    assert not r["correct"]
    assert r["checks"]["uncommitted_syncs"]["value"] >= 1


@pytest.mark.parametrize("control", CONTROLS)
def test_control_in_the_programs_place_fails(control):
    r = run(control=control)
    assert not r["correct"]
    assert r["checks"]["mismatched_docs"]["value"] >= 1


def test_typing_control_fails():
    # no concurrency in the typing mix: only the stale read shows there
    r = run("fused-typing", control="stale_by_one_sync")
    assert not r["correct"]
