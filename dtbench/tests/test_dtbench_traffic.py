"""The generator and the reference: determinism, tracked lengths, and the
reference against the program's own host merge on small tapes."""

import json

import pytest

from conftest import ROOT, SEED
from dtbench.reference.listcrdt import CONTROLS, merged_text
from dtbench.traffic.generate import DocGen, fold

MIXES = ("concurrent", "typing")


def mix(name):
    with open(f"{ROOT}/dtbench/traffic/{name}.json") as f:
        return json.load(f)


def small(name, **edits):
    m = mix(name)
    m["docs"].update(base_min=0, base_max=40, run_max=8)
    m["edits"].update(edits)
    return m


def syncs_of(gen, n):
    for _ in range(n):
        gen.syncs.append(gen.next_sync())
    return gen.syncs


@pytest.mark.parametrize("name", MIXES)
def test_generator_is_deterministic_by_seed(name):
    m = mix(name)
    a = syncs_of(DocGen(SEED, 3, m["docs"], m["edits"]), 4)
    b = syncs_of(DocGen(SEED, 3, m["docs"], m["edits"]), 4)
    c = syncs_of(DocGen(SEED + 1, 3, m["docs"], m["edits"]), 4)
    assert a == b
    assert a != c


@pytest.mark.parametrize("name", MIXES)
def test_tracked_length_is_the_reference_length(name):
    m = mix(name)
    for doc in range(3):
        gen = DocGen(SEED, doc, m["docs"], m["edits"])
        syncs_of(gen, 5)
        assert len(merged_text(gen.syncs)) == gen.length


def test_folded_syncs_merge_like_their_parts():
    m = small("typing")
    a = DocGen(SEED, 0, m["docs"], m["edits"])
    b = DocGen(SEED, 0, m["docs"], m["edits"])
    parts = [a.next_sync() for _ in range(5)]
    a.syncs += parts
    b.syncs.append(fold([b.next_sync() for _ in range(5)]))
    assert merged_text(a.syncs) == merged_text(b.syncs)


def port_text(gen):
    """The program's host merge of the same record (the test may import
    both; the reference imports nothing of the program)."""
    from diamond_types_tpu_torch import OpLog
    from dtbench.tiers import append_sync
    ol = OpLog()
    ids = {a: ol.get_or_create_agent_id(a) for a in gen.agents()}
    tip = []
    for sync in gen.syncs:
        tip = append_sync(ol, ids, tip, sync)
    return ol.checkout_tip().snapshot()


@pytest.mark.parametrize("edge_share", [0.0, 0.5, 0.9])
@pytest.mark.parametrize("name", ["concurrent", "typing"])
def test_reference_equals_the_programs_host_merge(name, edge_share):
    m = small(name, ops_max=8, ins_max=4, del_max=5) if name == "concurrent" \
        else small(name)
    if name == "concurrent":
        m["edits"]["edge_share"] = edge_share
    for doc in range(40):
        gen = DocGen(SEED + int(100 * edge_share), doc, m["docs"],
                     m["edits"])
        syncs_of(gen, 6)
        assert merged_text(gen.syncs) == port_text(gen), doc


@pytest.mark.parametrize("control", CONTROLS)
def test_controls_differ_from_the_reference(control):
    m = mix("concurrent")
    m["docs"].update(base_min=300, base_max=600)
    differ = 0
    for doc in range(6):
        gen = DocGen(SEED, doc, m["docs"], m["edits"])
        syncs_of(gen, 6)
        differ += merged_text(gen.syncs) != merged_text(gen.syncs, control)
    assert differ >= 5


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    code = ("import sys; sys.path.insert(0, %r); "
            "import dtbench.reference.listcrdt, dtbench.traffic.generate, "
            "dtbench.traffic.clients, dtbench.metrics, dtbench.tiers; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"diamond_types_tpu_torch", "diamond_types_tpu",
                       "jax", "jaxlib", "torch"}


@pytest.mark.parametrize("name", MIXES)
def test_syncs_prepared_in_set_up_are_the_ones_generated_later(name):
    m = mix(name)
    a = DocGen(SEED, 2, m["docs"], m["edits"])
    b = DocGen(SEED, 2, m["docs"], m["edits"])
    a.prepare(3)
    got = [a.next_sync() for _ in range(5)]      # 3 prepared, 2 made late
    assert got == [b.next_sync() for _ in range(5)]
    assert a.made_late == 2 and a.length == b.length


def test_only_linear_syncs_of_one_agent_fold():
    m = small("concurrent")
    gen = DocGen(SEED, 0, m["docs"], m["edits"])
    with pytest.raises(ValueError):
        fold([gen.next_sync(), gen.next_sync()])
