"""Long-running randomized soak harness — the CI fuzzers at campaign
scale (reference test strategy: SURVEY.md §4.2; the reference runs its
seeded fuzzers across threads with a failing-seed "parachute",
src/list_fuzzer_tools.rs fuzz_multithreaded — this is the rebuild's
equivalent, run for hours in the background rather than minutes in CI).

Each seed plays one scenario end to end:
  * 3-5 peers diverge with Unicode-heavy random edits (bigger docs and
    more rounds than the CI fuzzers in tests/test_fuzz.py);
  * random pair syncs alternate between the two real transports —
    whole-oplog merge (text/crdt.py merge_oplogs) and the wire
    protocol (version-summary handshake + binary patch,
    causalgraph/summary.py + encoding ENCODE_PATCH) — with pairwise
    byte-equality asserted after every sync;
  * full mesh sync at the end: every peer must converge byte-identical;
  * codec gauntlet on the final oplog: full-snapshot round-trip, a
    patch from a random mid version onto a fork, and a checkout at a
    random historical version re-checked against a fresh decode.

Failures log the seed (replay: `python -m diamond_types_tpu_torch.tools.soak
--seed0 <seed> --count 1`) and the campaign keeps going.

Every checkout reads through the C++ tracker (`Branch.merge_reference`),
on the host: a plain `checkout` may go to the zone engine on CUDA once
the engine policy has measured it faster, and the soak is host-only.

Usage:
  python -m diamond_types_tpu_torch.tools.soak --seed0 1000000 \
      --log /tmp/soak.jsonl            # run until killed
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import traceback

from ..causalgraph.summary import (intersect_with_summary,
                                   summarize_versions)

_REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))
from ..encoding.decode import decode_into, load_oplog
from ..encoding.encode import ENCODE_FULL, ENCODE_PATCH, encode_oplog
from ..text.branch import Branch
from ..text.crdt import ListCRDT, merge_oplogs

# Unicode-heavy alphabet, same spread as tests/test_fuzz.py (ASCII +
# Latin-1 + Greek + arrows + astral-plane symbols).
ALPHABET = ("abcdefghijklmnop_ XYZ123*&^%$#@!~`:;'\"|\n"
            "©¥½ΎΔδϠ←↯↻⇈"
            "\U00010190\U00010194\U00010198\U0001019a")

PEER_NAMES = ("alice", "bob", "carol", "dave", "erin")

BENCH_ACTIVE = os.path.join(_REPO_ROOT, ".bench_active")


def _pid_is(pid: int, needle: bytes) -> bool:
    """True if `pid` is alive AND its cmdline contains `needle`: a dead
    pid recycled by an unrelated process must not read as a live holder.
    Unreadable /proc (another uid) is conservatively treated as a match
    (the repo-root bench.py's pid guard, copied)."""
    if not pid:
        return False
    try:
        os.kill(pid, 0)
    except PermissionError:
        pass                    # exists, owned by another user
    except (OSError, ValueError):
        return False
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return needle in f.read()
    except OSError:
        return True


def bench_is_active() -> bool:
    """True while a bench run is in flight: a live holder pid in the
    repo root's `.bench_active` (the repo-root bench.py's
    `bench_is_active`, copied so the port imports nothing of it)."""
    try:
        with open(BENCH_ACTIVE) as f:
            pid = int(f.read().strip() or "0")
    except (OSError, ValueError):
        return False
    return _pid_is(pid, b"bench")


def checkout(ol, frontier) -> Branch:
    """`ol.checkout(frontier)` through the C++ tracker, on the host."""
    b = Branch()
    b.merge_reference(ol, list(frontier))
    return b


def checkout_tip(ol) -> Branch:
    return checkout(ol, ol.version)


def _random_edit(rng: random.Random, oplog, agent, version, content):
    doc_len = len(content)
    if doc_len == 0 or rng.random() < (0.65 if doc_len < 400 else 0.45):
        pos = rng.randint(0, doc_len)
        n = rng.randint(1, 8)
        s = "".join(rng.choice(ALPHABET) for _ in range(n))
        lv = oplog.add_insert_at(agent, version, pos, s)
        content = content[:pos] + s + content[pos:]
    else:
        start = rng.randint(0, doc_len - 1)
        n = min(rng.randint(1, 10), doc_len - start)
        lv = oplog.add_delete_at(agent, version, start, start + n,
                                 content[start:start + n])
        content = content[:start] + content[start + n:]
    return [lv], content


def _sync_pair(rng: random.Random, a, b) -> None:
    """Bidirectional sync via a random transport; both peers end at the
    same tip and must agree byte for byte."""
    if rng.random() < 0.5:
        merge_oplogs(a.oplog, b.oplog)
        merge_oplogs(b.oplog, a.oplog)
    else:
        # wire protocol: summary handshake + binary patch, both ways
        common_ab, _ = intersect_with_summary(
            a.oplog.cg, summarize_versions(b.oplog.cg))
        decode_into(b.oplog,
                    encode_oplog(a.oplog, ENCODE_PATCH,
                                 from_version=common_ab))
        common_ba, _ = intersect_with_summary(
            b.oplog.cg, summarize_versions(a.oplog.cg))
        decode_into(a.oplog,
                    encode_oplog(b.oplog, ENCODE_PATCH,
                                 from_version=common_ba))
    sa = checkout_tip(a.oplog).snapshot()
    sb = checkout_tip(b.oplog).snapshot()
    assert sa == sb, "pairwise divergence after sync"


def run_seed(seed: int) -> dict:
    """One full scenario; returns stats. Raises on any invariant break."""
    rng = random.Random(seed)
    n_peers = rng.randint(3, 5)
    peers = []
    for name in PEER_NAMES[:n_peers]:
        d = ListCRDT()
        d.get_or_create_agent_id(name)
        peers.append(d)
    states = [([], "") for _ in peers]       # (version, shadow content)

    rounds = rng.randint(12, 24)
    for _ in range(rounds):
        for idx, d in enumerate(peers):
            v, c = states[idx]
            for _ in range(rng.randint(1, 4)):
                v, c = _random_edit(rng, d.oplog, 0, v, c)
            states[idx] = (v, c)
        i, j = rng.sample(range(n_peers), 2)
        _sync_pair(rng, peers[i], peers[j])
        # local shadows are stale after a sync; refresh from checkout
        for k in (i, j):
            b = checkout_tip(peers[k].oplog)
            states[k] = (list(peers[k].oplog.version), b.snapshot())

    # full mesh: everyone syncs with everyone
    for i in range(n_peers):
        for j in range(n_peers):
            if i != j:
                merge_oplogs(peers[i].oplog, peers[j].oplog)
    finals = [checkout_tip(d.oplog).snapshot() for d in peers]
    assert all(f == finals[0] for f in finals), "mesh divergence"

    # codec gauntlet on peer 0
    ol = peers[0].oplog
    n_ops = len(ol)
    snap = encode_oplog(ol, ENCODE_FULL)
    ol2 = load_oplog(snap)
    assert checkout_tip(ol2).snapshot() == finals[0], "snapshot round-trip"
    # patch from a random mid version onto a fork that was split there
    mid = [rng.randrange(n_ops)] if n_ops else []
    mid = ol.cg.graph.find_dominators(mid)
    if mid:
        # LVs are renumbered densely by the file format, so the same
        # version must be named agent-wise across the decode boundary
        mid2 = ol2.cg.remote_to_local_frontier(
            ol.cg.local_to_remote_frontier(mid))
        # historical checkout must agree between original and decode
        assert checkout(ol, mid).snapshot() == \
            checkout(ol2, mid2).snapshot(), "historical checkout mismatch"
        patch = encode_oplog(ol, ENCODE_PATCH, from_version=mid)
        fork = load_oplog(snap)
        decode_into(fork, patch)   # idempotent over known ops
        assert checkout_tip(fork).snapshot() == finals[0], "patch ingest"
    return {"peers": n_peers, "rounds": rounds, "ops": n_ops,
            "doc_len": len(finals[0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed0", type=int, default=1_000_000)
    p.add_argument("--count", type=int, default=0,
                   help="seeds to run (0 = until killed)")
    p.add_argument("--log", default=None,
                   help="JSONL progress/failure log (default stdout)")
    args = p.parse_args(argv)

    out = open(args.log, "a") if args.log else sys.stdout

    def emit(obj):
        obj["ts"] = round(time.time(), 1)
        out.write(json.dumps(obj, ensure_ascii=False) + "\n")
        out.flush()

    emit({"event": "soak_start", "seed0": args.seed0, "count": args.count})
    done = failures = 0
    t0 = time.time()
    ops_total = 0
    seed = args.seed0

    # official bench runs must not compete with the soak for CPU
    while args.count == 0 or done < args.count:
        if bench_is_active():
            emit({"event": "paused", "why": "bench.py run in flight"})
            while bench_is_active():
                time.sleep(5)
            emit({"event": "resumed"})
        try:
            stats = run_seed(seed)
            ops_total += stats["ops"]
        except Exception:
            failures += 1
            emit({"event": "FAILURE", "seed": seed,
                  "traceback": traceback.format_exc()[-2000:]})
        done += 1
        seed += 1
        if done % 25 == 0:
            emit({"event": "progress", "seeds_done": done,
                  "failures": failures, "ops_total": ops_total,
                  "elapsed_s": round(time.time() - t0, 1)})
    emit({"event": "soak_end", "seeds_done": done, "failures": failures,
          "ops_total": ops_total})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
