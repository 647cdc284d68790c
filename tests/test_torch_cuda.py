"""The port's hand-written kernels on a CUDA card.

K1 has no CPU mode, so these tests skip without a card (each decides
inside the test). They import nothing of JAX: run them on a card host with
`python -m pytest tests/test_torch_cuda.py -m cuda -q`. `chip_smoke.py`
covers the same ground at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from diamond_types_tpu_torch import OpLog
from diamond_types_tpu_torch.gpu import flush_fuse as ff
from diamond_types_tpu_torch.gpu import kernels

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no interpret mode")


def _window(seed, b, n, cap, mi):
    rng = np.random.default_rng(seed)
    docs = rng.integers(1, 0x10FFFF, (b, cap))
    lens = rng.integers(0, cap, b)
    pos = np.where(rng.random((b, n)) < 0.3,
                   cap - rng.integers(1, mi + 2, (b, n)),
                   rng.integers(0, cap + 3, (b, n)))
    kind = rng.integers(0, 4, (b, n))
    dlen = np.where(kind % 3 != 0, rng.integers(1, mi + 1, (b, n)), 0)
    ilen = np.where(kind % 2 == 0, rng.integers(1, mi + 1, (b, n)), 0)
    ilen[kind == 3] = 0
    chars = rng.integers(1, 0x10FFFF, (b, n, mi))
    dlen[0, n // 2] = mi + 1                       # poisons row 0
    lens[-1] = -1                                  # inert padding row
    pos[-1] = dlen[-1] = ilen[-1] = 0
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()
            for a in (docs, lens, pos, dlen, ilen, chars)]


@pytest.mark.parametrize("b,n,cap", [(3, 8, 256), (8, 64, 4096),
                                     (4, 16, 32768), (4, 16, 65536)])
def test_kernel_matches_plain_on_card(b, n, cap):
    _need_card()
    mi = 16
    args = _window(cap + n, b, n, cap, mi)
    before = [a.clone() for a in args]
    launches = kernels.apply_ops_window.launches
    got_d, got_l = kernels.apply_ops_window(*args, mi)
    torch.cuda.synchronize()
    assert kernels.apply_ops_window.launches == launches + 1
    want_d, want_l = kernels.apply_ops_window_plain(*args, mi)
    assert torch.equal(got_d, want_d) and torch.equal(got_l, want_l)
    assert int(got_l[0]) == -1 and int(got_l[-1]) == -1
    for a, a0 in zip(args, before):                # inputs never written
        assert torch.equal(a, a0)


def test_kernel_rung_on_card_matches_cpu_sessions():
    """The same oplogs flushed through CUDA sessions (K1) and CPU
    sessions (K1's plain version): equal fences, texts and buffers; a
    poisoned row keeps its pre-window state on the card."""
    _need_card()
    rng = np.random.default_rng(1)
    ols = []
    for d in range(5):
        ol = OpLog()
        a = ol.get_or_create_agent_id("a")
        ol.add_insert(a, 0, "x" * int(rng.integers(50, 400)))
        ols.append(ol)
    gpu = [ff.FusedDocSession(ol, max_ins=4, device="cuda") for ol in ols]
    cpu = [ff.FusedDocSession(ol, max_ins=4, device="cpu") for ol in ols]
    for w in range(3):
        for ol in ols:
            b = ol.get_or_create_agent_id(f"b{w}")
            ol.add_insert_at(b, [int(rng.integers(3, 40))], 3, "concurrent!")
            ol.add_delete_without_content(
                ol.get_or_create_agent_id("a"), 1, 9)
        gplans = [s.plan_tail() for s in gpu]
        cplans = [s.plan_tail() for s in cpu]
        if w == 1:
            gplans[2].dlen[0] = cplans[2].dlen[0] = 5     # > max_ins
        kept = gpu[2].docs.clone()
        by_cap = {}
        for i, s in enumerate(gpu):
            by_cap.setdefault(s.cap, []).append(i)
        for idx in by_cap.values():
            gok, _ = ff.kernel_fused_replay([gpu[i] for i in idx],
                                            [gplans[i] for i in idx])
            cok, _ = ff.kernel_fused_replay([cpu[i] for i in idx],
                                            [cplans[i] for i in idx])
            assert gok == cok
        if w == 1:
            assert torch.equal(gpu[2].docs, kept)
            gpu[2] = ff.FusedDocSession(ols[2], max_ins=4, device="cuda")
            cpu[2] = ff.FusedDocSession(ols[2], max_ins=4, device="cpu")
        for g, c, ol in zip(gpu, cpu, ols):
            assert g.text() == c.text() == ol.checkout_tip().snapshot()
            assert torch.equal(g.docs.cpu(), c.docs)
