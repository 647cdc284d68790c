"""The port's native bindings against the JAX package's.

Both load the same C++ merge core (`native/dt_core.cpp`), each from its
own build: the port compiles it into `diamond_types_tpu_torch/_build/`.
The same concurrent histories (3-5 agents, `TwinDocs`) go into a JAX
`OpLog` and a port `OpLog`; every dump the device transform and the device
checkout read must be exactly equal.
"""

from pathlib import Path

import numpy as np
import pytest

from diamond_types_tpu.native.core import get_native_ctx as jax_ctx
from diamond_types_tpu.text.oplog import OpLog as JaxOpLog
from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.native import build as nbuild
from diamond_types_tpu_torch.native.core import get_native_ctx

from torch_parity import UNICODE, TwinDocs

REPO = Path(__file__).resolve().parent.parent


def _history(seed: int, agents: int, alphabet: str = "abcdefghij"):
    names = [f"agent{k}" for k in range(agents)]
    tw = TwinDocs([JaxOpLog(), OpLog()], seed, alphabet)
    tw.type_base(names[0], 60 + 10 * agents)
    marks = []
    for _ in range(3):
        marks.append(list(tw.oplogs[1].version))
        tw.fork(names)
        tw.concurrent_round(names, 5)
    return tw, marks


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x)
        else:
            assert y == x


@pytest.mark.parametrize("agents,alphabet", [(3, "abcdefghij"),
                                             (4, UNICODE), (5, "xyz")])
def test_native_dumps_match_jax_package(agents, alphabet):
    tw, marks = _history(40 + agents, agents, alphabet)
    jo, to = tw.oplogs
    jc, tc = jax_ctx(jo), get_native_ctx(to)
    zones = 0
    for frm in [[]] + marks:
        _equal(jc.transform(frm, jo.version), tc.transform(frm, to.version))
        _equal(jc.dump_tracker(keep_underwater=True),
               tc.dump_tracker(keep_underwater=True))
        _equal(jc.dump_tracker(), tc.dump_tracker())
        _equal(jc.dump_del_rows(), tc.dump_del_rows())
        assert tc.zone_common() == jc.zone_common()
        zones += len(tc.dump_tracker()[0]) > 0
        tc.release_tracker()
        jc.release_tracker()
        got = tc.merge_to_string("", [], frm)
        assert got == jc.merge_to_string("", [], frm)
        assert got[0] == to.checkout(frm).snapshot()
    assert zones >= 2            # the histories really are concurrent
    full = tc.merge_to_string("", [], to.version)
    assert full[0] == to.checkout_tip().snapshot()
    assert sorted(full[1]) == sorted(to.version)


def test_context_is_cached_on_the_oplog_and_follows_growth():
    tw, _ = _history(7, 3)
    to = tw.oplogs[1]
    ctx = get_native_ctx(to)
    assert to._native_ctx is ctx and get_native_ctx(to) is ctx
    tw.concurrent_round(["agent0", "agent1", "agent2"], 3)
    assert ctx.merge_to_string("", [], to.version)[0] == \
        to.checkout_tip().snapshot()


def test_library_is_the_ports_own_build():
    """The port loads its own build under `_build/`, named by a hash of
    both sources and the flags, never the JAX package's
    `native/libdt_core.so`; a second build call finds it built."""
    to = OpLog()
    to.add_insert(to.get_or_create_agent_id("a"), 0, "abc")
    lib = Path(get_native_ctx(to)._lib._name).resolve()
    assert lib.parent == (REPO / "diamond_types_tpu_torch" / "_build")
    assert lib == nbuild.library_path()
    assert lib != (REPO / "native" / "libdt_core.so").resolve()
    assert [p.name for p in nbuild.SOURCES] == ["dt_core.cpp",
                                                "dt_decode.cpp"]
    assert nbuild.build() == (lib, 0.0)
