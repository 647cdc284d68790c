"""Seeded fixture: the port's device dispatches under the oplog guard.

Each method launches a kernel (or waits on the card) while it holds the
store lock. The port's dt-lint names these calls as device dispatch
(`analysis/rules/locks.py` DISPATCH_BASE) and fires device-under-lock on
every one; the JAX package's lint does not know the names and stays
silent.
"""

import threading


class DocStore:
    def __init__(self):
        self.lock = threading.Lock()

    def k1(self, kernels, args):
        with self.lock:
            return kernels.apply_ops_window(*args)

    def k2(self, kernels, nv, ov):
        with self.lock:
            return kernels.xform_positions(nv, ov)

    def k3(self, kernels, args):
        with self.lock:
            return kernels.materialize_runs(*args)

    def x8(self, kernels, carry, xs, plen):
        with self.lock:
            return kernels.zone_tape_run(carry, xs, plen)

    def replay(self, kernels, args):
        with self.lock:
            return kernels.replay_batch_kernel(*args)

    def wait(self, torch):
        with self.lock:
            torch.cuda.synchronize()

    def checkouts(self, merge_kernel, docs):
        with self.lock:
            return merge_kernel.checkout_batch_device(docs)

    def strip(self, plan_kernels, ol, idxs):
        with self.lock:
            return plan_kernels.texts_at_versions(ol, idxs)

    def resolve(self, kernels, buf, b, n):
        with self.lock:
            kernels.resolve_rows(buf, b, n)
