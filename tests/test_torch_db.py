"""The port's `db/` (multi-CRDT `Doc`, `Shelf`) against the JAX package's.

Each fuzz case runs one script, driven by a `random.Random(seed)` stream
per package, through both packages. Two replicas that exchange deltas both
ways must converge within each package and equal the other package's
checkout, the JSON deltas (`ops_since`) must be the same strings, and a
replica of one package must rebuild the other's state from its delta.
With three replicas, or deltas sent one way, the JAX package's `Doc` does
not always converge; there the port must give its very outcome.
"""

import json
import random

import pytest

from diamond_types_tpu.db import doc as jdoc
from diamond_types_tpu.db import shelf as jshelf
from diamond_types_tpu_torch.db import doc as tdoc
from diamond_types_tpu_torch.db import shelf as tshelf

KEYS = ("a", "b", "c", "title")
ALPHABET = "xyz é😀中"


def _doc_script(mod, seed: int, n_reps: int = 3, steps: int = 40,
                one_way: bool = False):
    """`n_reps` replicas of one document: a root map with primitive
    registers, a nested map and two text CRDTs, edited concurrently and
    synced now and then by JSON deltas."""
    rng = random.Random(seed)
    reps = [mod.Doc() for _ in range(n_reps)]
    agents = [d.get_or_create_agent_id(f"agent{i}")
              for i, d in enumerate(reps)]
    reps[0].map_create_crdt(agents[0], mod.ROOT_CRDT, "body", mod.KIND_TEXT)
    reps[0].map_create_crdt(agents[0], mod.ROOT_CRDT, "notes", mod.KIND_TEXT)
    reps[0].map_create_crdt(agents[0], mod.ROOT_CRDT, "meta", mod.KIND_MAP)
    for d in reps[1:]:
        d.merge_ops(reps[0].ops_since([]))
    deltas = []
    for _ in range(steps):
        i = rng.randrange(n_reps)
        d, a = reps[i], agents[i]
        r = rng.random()
        if r < 0.25:
            d.map_set(a, mod.ROOT_CRDT, rng.choice(KEYS),
                      rng.choice([rng.randint(0, 99), "s", None, True]))
        elif r < 0.35:
            meta = next(lv for (crdt, key), vals in d.map_keys.items()
                        if key == "meta" for lv, _v in vals)
            d.map_set(a, meta, rng.choice(KEYS), rng.randint(0, 9))
        else:
            tid = sorted(d.texts)[rng.randrange(len(d.texts))]
            cur = d.checkout_text(tid)
            if cur and rng.random() < 0.35:
                s = rng.randrange(len(cur))
                d.text_delete(a, tid, s, min(len(cur), s + rng.randint(1, 3)))
            else:
                d.text_insert(a, tid, rng.randint(0, len(cur)),
                              "".join(rng.choice(ALPHABET)
                                      for _ in range(rng.randint(1, 4))))
        if rng.random() < 0.3:
            # two replicas exchange full deltas both ways (versions are
            # local LVs, so a replica cannot name another's; the receiver
            # skips what it already knows)
            j = rng.randrange(n_reps)
            if j != i or not one_way:
                deltas.append(d.ops_since([]))
                reps[j].merge_ops(deltas[-1])
                if not one_way:
                    deltas.append(reps[j].ops_since([]))
                    d.merge_ops(deltas[-1])
    for d in reps:
        for e in reps:
            if d is not e:
                e.merge_ops(d.ops_since([]))
    return reps, deltas


@pytest.mark.parametrize("seed", range(10))
def test_doc_fuzz_converges_like_jax(seed):
    jreps, jdeltas = _doc_script(jdoc, seed, n_reps=2)
    treps, tdeltas = _doc_script(tdoc, seed, n_reps=2)
    assert tdeltas == jdeltas
    want = jreps[0].checkout()
    for d in jreps + treps:
        assert d.checkout() == want
    for jd, td in zip(jreps, treps):
        assert td.version == jd.version
        assert td.ops_since([]) == jd.ops_since([])
        # the delta of one package rebuilds the state in the other
        for src, mod in ((jd, tdoc), (td, jdoc)):
            fresh = mod.Doc()
            fresh.merge_ops(src.ops_since([]))
            assert fresh.checkout() == want
            assert fresh.ops_since([]) == src.ops_since([])
    json.dumps(want)       # the checkout is a JSON tree


def _outcome(mod, seed: int, **kw):
    try:
        reps, deltas = _doc_script(mod, seed, **kw)
        return ("ran", [d.checkout() for d in reps], deltas)
    except Exception as e:     # the same fault is expected of both
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("kw", [{"n_reps": 3}, {"n_reps": 3, "one_way": True},
                                {"n_reps": 2, "one_way": True}])
def test_doc_beyond_two_way_pairs_matches_jax(seed, kw):
    """Three replicas, or deltas sent one way only: the JAX package's Doc
    does not always converge here (or raises on a delta whose parent it
    has not seen); the port must do exactly what it does."""
    assert _outcome(tdoc, seed, **kw) == _outcome(jdoc, seed, **kw)


@pytest.mark.parametrize("seed", range(3))
def test_doc_concurrent_registers_surface_conflicts_like_jax(seed):
    outs = []
    for mod in (jdoc, tdoc):
        rng = random.Random(seed)
        d1 = mod.Doc()
        a = d1.get_or_create_agent_id("alice")
        d1.map_set(a, mod.ROOT_CRDT, "x", 0)
        d2 = mod.Doc()
        d2.merge_ops(d1.ops_since([]))
        b = d2.get_or_create_agent_id("bob")
        base = d1.version
        for _ in range(rng.randint(1, 4)):
            d1.map_set(a, mod.ROOT_CRDT, "x", rng.randint(1, 50))
            d2.map_set(b, mod.ROOT_CRDT, "x", rng.randint(51, 99))
        d1.merge_ops(d2.ops_since(base))
        d2.merge_ops(d1.ops_since(base))
        assert d1.checkout() == d2.checkout()
        outs.append(d1.checkout())
    assert outs[0] == outs[1] and "_conflicts" in outs[1]


def _shelf_script(mod, seed: int, n_reps: int = 3, steps: int = 60):
    rng = random.Random(seed)
    reps = [mod.new_shelf({}) for _ in range(n_reps)]
    for _ in range(steps):
        i = rng.randrange(n_reps)
        r = rng.random()
        if r < 0.6:
            reps[i] = mod.set_key(reps[i], rng.choice(KEYS),
                                  rng.choice([rng.randint(0, 9), "v", None,
                                              [rng.randint(0, 3)]]))
        elif r < 0.7:
            reps[i] = mod.set_value(reps[i], {})       # a newer empty map
        else:
            j = rng.randrange(n_reps)
            reps[i] = mod.merge(reps[i], reps[j])
    merged = reps[0]
    for s in reps[1:]:
        merged = mod.merge(merged, s)
    return reps, merged


@pytest.mark.parametrize("seed", range(10))
def test_shelf_fuzz_converges_like_jax(seed):
    jreps, jmerged = _shelf_script(jshelf, seed)
    treps, tmerged = _shelf_script(tshelf, seed)
    assert treps == jreps and tmerged == jmerged
    # merge is commutative and idempotent: every fold order converges
    for mod, reps, merged in ((jshelf, jreps, jmerged),
                              (tshelf, treps, tmerged)):
        rev = reps[-1]
        for s in reversed(reps[:-1]):
            rev = mod.merge(rev, s)
        assert mod.get(rev) == mod.get(merged)
        assert mod.merge(merged, merged) == merged
    assert tshelf.get(tmerged) == jshelf.get(jmerged)
