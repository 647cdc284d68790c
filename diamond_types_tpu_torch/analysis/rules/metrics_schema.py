"""Metrics-schema drift rule (error).

The repo's metrics contract is "declared key surfaces, fixed at
module scope": ReplicationMetrics._GROUPS, serve's _SHARD_KEYS /
HYDRATION_KEYS, read's READ_KEYS, storage's TIER_KEYS. The prom
renderer zero-fills families from those same tuples, and the PR 10
live-telemetry double-write derives its TimeSeries names from them
(`repl.{group}.{key}`, `read.{key}`, `serve.{key}`). A producer that
bumps a key missing from its declared tuple either raises at runtime
(ReadMetrics) or silently mints a counter no renderer ever exports
(dict-backed producers) — both are schema drift.

This rule cross-references, at lint time, every literal-keyed
recording call against the REAL declared tuples (imported, not
copied, so the rule can never drift from the schema itself):

  .bump("group", "key")        both in ReplicationMetrics._GROUPS
  .bump("group", key_var)      group-forwarding wrapper: group exists
  .bump(shard_var, "key")      ServeMetrics style: key in _SHARD_KEYS
  ._bump("key") / .bump("key") key in SOME declared single-key surface
  .record_hydration("key")     key in HYDRATION_KEYS
  .observe_latency("name")     name in the replication histogram set
  .bump_wire("chan", "key")    chan in wire.frames.WIRE_CHANNELS and
                               key in WIRE_KEYS (the flat `wire` group
                               key is derived as f"{chan}_{key}", so
                               the generic literal check can't see it)
  .account("chan", sent_bytes=...)  WireChannel accounting entrypoint:
                               chan in WIRE_CHANNELS (only calls that
                               pass a wire accounting keyword are
                               matched — `.account` alone is too
                               generic a method name)
  .bump_class("cls", "key")    cls in qos.classes.QOS_CLASSES and key
                               in qos.metrics.QOS_CLASS_KEYS (the
                               dt_qos_*{class} prom families zero-fill
                               from those same tuples)
  .bump_ctl("key")             key in qos.metrics.QOS_CTL_KEYS
  .open_incident("kind", ...)  kind in obs.incident.INCIDENT_KINDS
                               (also `_open_locked` — the detector's
                               internal entrypoint; the dt_incident_*
                               prom families zero-fill from that same
                               tuple, so an undeclared kind would mint
                               a bundle no renderer ever counts)

plus the exemplar join: a module defining `_EXEMPLAR_FAMILIES` (the
prom histogram -> TimeSeries mapping) must only name families some
producer actually writes — the full family string, or its last-dot
suffix, must appear as a literal in an inc/observe/observe_latency
call somewhere in the linted tree (summary.metric_literals).

The single-key check is a union across surfaces: a key valid for tier
but bumped on the read path would pass. That imprecision is accepted
— the drift failure this rule exists for is "key renamed/added on one
side only", which the union does catch.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ..lint import FileContext, Violation
from ...obs.incident import INCIDENT_KINDS
from ...qos.classes import QOS_CLASSES
from ...qos.metrics import QOS_CLASS_KEYS, QOS_CTL_KEYS
from ...read.metrics import READ_KEYS
from ...replicate.metrics import _GROUPS, _LATENCY_NAMES
from ...serve.metrics import HYDRATION_KEYS, _SHARD_KEYS
from ...storage.tier import TIER_KEYS
from ...wire.frames import WIRE_CHANNELS, WIRE_KEYS

# keywords that mark an `.account(...)` call as wire accounting (the
# bare method name is too generic to match on its own)
_WIRE_ACCOUNT_KWARGS = {"sent_bytes", "json_bytes", "framed", "snapshot"}

_GROUP_KEYS = {k for keys in _GROUPS.values() for k in keys}
# every declared single-key surface a bare `.bump("key")` may target
_SINGLE_KEYS = (set(READ_KEYS) | set(HYDRATION_KEYS)
                | set(_SHARD_KEYS) | set(TIER_KEYS) | _GROUP_KEYS)

_RECORDERS = {"bump", "_bump", "_bump_group"}


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def check_metrics_schema(ctx: FileContext, summary) -> List[Violation]:
    out: List[Violation] = []

    def violate(line: int, msg: str) -> None:
        out.append(Violation(rule="metrics-schema-drift", path=ctx.rel,
                             line=line, message=msg))

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            name = node.func.attr
            args = node.args
            if name in _RECORDERS and args:
                a0 = _const_str(args[0])
                a1 = _const_str(args[1]) if len(args) > 1 else None
                if a0 is not None and a1 is not None:
                    if a0 in _GROUPS:
                        if a1 not in _GROUPS[a0]:
                            violate(node.lineno,
                                    f"bump key {a1!r} is not declared "
                                    f"in ReplicationMetrics._GROUPS"
                                    f"[{a0!r}] — prom zero-fill and "
                                    f"the repl.{a0}.* time-series "
                                    f"table will never export it")
                    elif a1 in _GROUP_KEYS:
                        violate(node.lineno,
                                f"bump group {a0!r} is not declared "
                                f"in ReplicationMetrics._GROUPS (key "
                                f"{a1!r} belongs to a declared group)")
                elif a0 is not None:
                    # single literal: a direct key, or a
                    # group-forwarding wrapper's bound group
                    if a0 not in _GROUPS and a0 not in _SINGLE_KEYS:
                        violate(node.lineno,
                                f"bump key {a0!r} is not declared on "
                                f"any metrics surface (_GROUPS, "
                                f"_SHARD_KEYS, HYDRATION_KEYS, "
                                f"READ_KEYS, TIER_KEYS)")
                elif a1 is not None:
                    # ServeMetrics style: bump(shard, "key")
                    if a1 not in _SINGLE_KEYS:
                        violate(node.lineno,
                                f"bump key {a1!r} is not declared on "
                                f"any metrics surface")
            elif name == "bump_wire" and args:
                a0 = _const_str(args[0])
                a1 = _const_str(args[1]) if len(args) > 1 else None
                if a0 is not None and a0 not in WIRE_CHANNELS:
                    violate(node.lineno,
                            f"wire channel {a0!r} is not in "
                            f"wire.frames.WIRE_CHANNELS "
                            f"{WIRE_CHANNELS} — the dt_wire_* prom "
                            f"families will never export it")
                if a1 is not None and a1 not in WIRE_KEYS:
                    violate(node.lineno,
                            f"wire key {a1!r} is not in "
                            f"wire.frames.WIRE_KEYS {WIRE_KEYS}")
            elif name == "account" and args and any(
                    kw.arg in _WIRE_ACCOUNT_KWARGS
                    for kw in node.keywords):
                a0 = _const_str(args[0])
                if a0 is not None and a0 not in WIRE_CHANNELS:
                    violate(node.lineno,
                            f"wire channel {a0!r} is not in "
                            f"wire.frames.WIRE_CHANNELS "
                            f"{WIRE_CHANNELS}")
            elif name == "bump_class" and args:
                a0 = _const_str(args[0])
                a1 = _const_str(args[1]) if len(args) > 1 else None
                if a0 is not None and a0 not in QOS_CLASSES:
                    violate(node.lineno,
                            f"qos class {a0!r} is not in "
                            f"qos.classes.QOS_CLASSES {QOS_CLASSES} — "
                            f"the dt_qos_* prom families zero-fill "
                            f"only the declared taxonomy")
                if a1 is not None and a1 not in QOS_CLASS_KEYS:
                    violate(node.lineno,
                            f"qos counter {a1!r} is not in "
                            f"qos.metrics.QOS_CLASS_KEYS "
                            f"{QOS_CLASS_KEYS}")
            elif name == "bump_ctl" and args:
                a0 = _const_str(args[0])
                if a0 is not None and a0 not in QOS_CTL_KEYS:
                    violate(node.lineno,
                            f"qos controller decision {a0!r} is not "
                            f"in qos.metrics.QOS_CTL_KEYS "
                            f"{QOS_CTL_KEYS}")
            elif name in ("open_incident", "_open_locked") and args:
                a0 = _const_str(args[0])
                if a0 is not None and a0 not in INCIDENT_KINDS:
                    violate(node.lineno,
                            f"incident kind {a0!r} is not in "
                            f"obs.incident.INCIDENT_KINDS "
                            f"{INCIDENT_KINDS} — the dt_incident_* "
                            f"prom families zero-fill only the "
                            f"declared kinds (open_incident would "
                            f"also raise at runtime)")
            elif name == "record_hydration" and args:
                a0 = _const_str(args[0])
                if a0 is not None and a0 not in HYDRATION_KEYS:
                    violate(node.lineno,
                            f"hydration event {a0!r} is not in "
                            f"serve.metrics.HYDRATION_KEYS — the "
                            f"residency-tier prom block will never "
                            f"carry it")
            elif name == "observe_latency" and args:
                a0 = _const_str(args[0])
                if a0 is not None and a0 not in _LATENCY_NAMES:
                    violate(node.lineno,
                            f"latency family {a0!r} is not in the "
                            f"replication histogram set "
                            f"{_LATENCY_NAMES}")
        elif isinstance(node, ast.Assign):
            # the prom exemplar join: families must have a producer
            names = {t.id for t in node.targets
                     if isinstance(t, ast.Name)}
            if "_EXEMPLAR_FAMILIES" not in names \
                    or not isinstance(node.value, ast.Dict):
                continue
            for v in node.value.values:
                fam = _const_str(v)
                if fam is None:
                    continue
                suffix = fam.rsplit(".", 1)[-1]
                lits = summary.metric_literals
                if fam not in lits and suffix not in lits:
                    violate(v.lineno,
                            f"exemplar family {fam!r} has no "
                            f"producer: neither the family nor its "
                            f"suffix appears in any inc/observe/"
                            f"observe_latency call in the linted "
                            f"tree")
    return out
