"""The port's own ctypes bindings over the repo's C++ merge core
(`native/dt_core.cpp`), built into `diamond_types_tpu_torch/_build/`, and
its local-ingest extension (`native/dt_ingest.cpp`, see `ingest.py`).
Nothing is built at import."""

import os

from .core import (NativeContext, merge_native,  # noqa: F401
                   native_available, native_counters, reset_native_counters,
                   transform_native)


def native_ctx_or_none(oplog):
    """The oplog's native context, or None when the native engine is
    disabled (DT_TPU_NO_NATIVE) or the library cannot be built here: the
    one gate of every native fast path that needs a per-oplog context
    (composer, tape packer, tracker merge, collision count)."""
    if os.environ.get("DT_TPU_NO_NATIVE"):
        return None
    from .core import get_native_ctx
    if not native_available():
        return None
    return get_native_ctx(oplog)
