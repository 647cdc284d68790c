"""Rule registry for the dt-lint engine.

Each rule is `fn(ctx: FileContext, summary: CallSummary) ->
Iterable[Violation]`. Rule names, severities and the canonical lock
order live in lint.py / rules/locks.py; the human-facing contract is
serve/README.md "Concurrency invariants".
"""

from __future__ import annotations

from .dataflow import check_dataflow
from .fencing import check_fencing
from .jit_purity import check_jit_purity
from .locks import check_locks
from .metrics_schema import check_metrics_schema

RULES = (check_locks, check_fencing, check_jit_purity,
         check_dataflow, check_metrics_schema)

__all__ = ["RULES", "check_locks", "check_fencing", "check_jit_purity",
           "check_dataflow", "check_metrics_schema"]
