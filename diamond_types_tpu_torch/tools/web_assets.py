"""Static HTML/JS for the browser demo client and merge visualizer.

Capability mirror of the reference's browser tier (reference:
wiki/client/dt_doc.ts:40-171 — a live collaborative editor against the sync
server; vis/src/App.svelte — the merge/DAG visualizer). The reference's
client runs the CRDT itself via WASM; this client is the reference's OTHER
documented integration mode — a plain positional ("dumb") client speaking
operational transform (reference README.md:31-33: "interoperable with
positional updates ... via operational transform"), so the browser needs no
CRDT at all: it sends positional edits tagged with the version it saw and
catches up by applying server-computed traversal ops (text/ot.py).

Positions on the wire are CODE POINTS everywhere: JS strings are UTF-16,
so both clients diff/apply over Array.from code-point arrays and convert
the cursor at the boundary (the reference ships wchar conversion for the
same split; here the conversion lives client-side, pinned by the astral
end-to-end tests in tests/test_server.py).
"""

INDEX_HTML = """<!doctype html>
<meta charset="utf-8"><title>diamond-types-tpu</title>
<style>
 body{font:15px system-ui;margin:3em auto;max-width:40em;color:#222}
 input{font:inherit;padding:.3em}</style>
<h1>diamond-types-tpu sync server</h1>
<p>Open a document (creates it if missing):</p>
<form onsubmit="go();return false">
 <input id="d" placeholder="doc id" value="note">
 <button>edit</button>
 <button type=button onclick="vis()">visualize</button>
 <button type=button onclick="crdt()">crdt peer</button>
</form>
<p style="font-size:13px;color:#777">"edit" is the positional dumb
client (server-side OT); "crdt peer" runs the full CRDT in your browser
— it edits offline and merges locally.</p>
<script>
 const f=()=>document.getElementById('d').value.trim()||'note';
 function go(){location.href='/edit/'+encodeURIComponent(f())}
 function vis(){location.href='/vis/'+encodeURIComponent(f())}
 function crdt(){location.href='/crdt/'+encodeURIComponent(f())}
</script>
"""

EDITOR_HTML = """<!doctype html>
<meta charset="utf-8"><title>edit: __DOC__</title>
<style>
 body{font:15px system-ui;margin:2em auto;max-width:46em;color:#222}
 textarea{width:100%;height:24em;font:14px/1.5 ui-monospace,monospace;
          padding:1em;box-sizing:border-box;border:1px solid #bbb;
          border-radius:6px}
 #st{color:#777;font-size:13px;margin-top:.5em}
 a{color:#06c}
</style>
<h2>__DOC__ <a href="/vis/__DOC__" style="font-size:14px">DAG</a></h2>
<textarea id="t" spellcheck="false" disabled>loading…</textarea>
<div id="st">connecting…</div>
<script>
const DOC = "__DOC__";
const AGENT = "web-" + Math.random().toString(36).slice(2, 8);
const ta = document.getElementById("t"), st = document.getElementById("st");
let version = null, shadow = "", inflight = false, queue = [];
let pollFails = 0;

const api = (path, body) => fetch(`/doc/${DOC}/${path}`, {
  method: "POST", body: JSON.stringify(body)}).then(r => r.json());

// Positions on the wire are CODE POINTS (the server's unit — the
// reference's wchar_conversion exists because JS strings are UTF-16:
// diffing on raw string indices would drift past any astral char and
// could split surrogate pairs). Diff over code-point arrays instead.
const cpOf = (s, units) => {     // UTF-16 index -> code-point position
  let n = 0;
  for (let k = 0; k < units; n++) k += s.codePointAt(k) > 0xFFFF ? 2 : 1;
  return n;
};
const unitOf = (s, cp) => {      // code-point position -> UTF-16 index
  let k = 0;
  for (let n = 0; n < cp && k < s.length; n++)
    k += s.codePointAt(k) > 0xFFFF ? 2 : 1;
  return k;
};

// Single-edit diff: common prefix/suffix between shadow and textarea.
function diffOps(oldS, newS) {
  if (oldS === newS) return [];
  const a = Array.from(oldS), b = Array.from(newS);
  let p = 0, oe = a.length, ne = b.length;
  while (p < oe && p < ne && a[p] === b[p]) p++;
  while (oe > p && ne > p && a[oe - 1] === b[ne - 1]) { oe--; ne--; }
  const ops = [];
  if (oe > p) ops.push({kind: "del", start: p, end: oe});
  if (ne > p) ops.push({kind: "ins", pos: p, text: b.slice(p, ne).join("")});
  return ops;
}

function applyTraversal(text, op, cursorUnits) {
  const chars = Array.from(text);
  let cur = cpOf(text, cursorUnits);
  let pos = 0;
  const out = [];
  for (const c of op) {
    if (typeof c === "number") {
      for (let i = 0; i < c; i++) out.push(chars[pos + i]);
      pos += c;
    } else if (typeof c === "string") {
      const ins = Array.from(c);
      if (out.length <= cur) cur += ins.length;
      out.push(...ins);
    } else {
      if (out.length < cur) cur = Math.max(out.length, cur - c.d);
      pos += c.d;
    }
  }
  const full = out.join("") + chars.slice(pos).join("");
  return [full, unitOf(full, cur)];
}

function onInput() {
  const ops = diffOps(shadow, ta.value);
  if (ops.length) { queue.push(...ops); shadow = ta.value; pump(); }
}

async function pump() {
  if (inflight || !queue.length) return;
  inflight = true;
  const batch = queue.splice(0);
  try {
    const r = await api("edit", {agent: AGENT, version, ops: batch});
    version = r.version;
    st.textContent = `saved · version ${JSON.stringify(version)}`;
  } catch (e) {
    st.textContent = "edit failed (retrying): " + e;
    queue.unshift(...batch);
    inflight = false;
    setTimeout(pump, 1500);   // back off instead of hammering the server
    return;
  }
  inflight = false;
  pump();
}

async function poll() {
  if (!inflight && !queue.length) {
    const v0 = version;
    try {
      // long-poll: the server holds the request until new ops arrive
      // (braid-subscription equivalent), so remote edits appear promptly
      const r = await api("changes", {version: v0, wait: 20});
      // An edit raced the request: its response version superseded v0 and
      // the traversal below would replay our own op. Drop this round.
      if (!inflight && !queue.length && version === v0) {
        if (r.op.length) {
          const [text, cur] = applyTraversal(shadow, r.op,
                                             ta.selectionStart);
          shadow = text; ta.value = text;
          ta.setSelectionRange(cur, cur);
        }
        version = r.version;
        st.textContent = `synced · version ${JSON.stringify(version)}`;
      }
      pollFails = 0;
    } catch (e) { st.textContent = "sync lost: " + e; pollFails++; }
  }
  // fast re-poll after a successful long-poll; back off when the server
  // is unreachable so dead tabs don't hammer it
  setTimeout(poll, pollFails ? Math.min(500 << pollFails, 8000) : 150);
}

(async () => {
  const r = await fetch(`/doc/${DOC}/state`).then(r => r.json());
  version = r.version; shadow = r.text;
  ta.value = r.text; ta.disabled = false; ta.focus();
  ta.addEventListener("input", onInput);
  st.textContent = "connected as " + AGENT;
  poll();
})();
</script>
"""

VIS_HTML = """<!doctype html>
<meta charset="utf-8"><title>DAG: __DOC__</title>
<style>
 body{font:14px system-ui;margin:1.5em;color:#222}
 #wrap{display:flex;gap:1.5em}
 svg{border:1px solid #ccc;border-radius:6px;background:#fafafa}
 #side{max-width:26em}
 pre{background:#f4f4f4;padding:.8em;border-radius:6px;white-space:pre-wrap}
 .run{cursor:pointer}
 .run:hover rect{stroke:#06c;stroke-width:2}
</style>
<h2>causal graph: __DOC__ <a href="/edit/__DOC__"
 style="font-size:14px">editor</a></h2>
<div id="wrap">
 <svg id="g" width="640" height="200"></svg>
 <div id="side"><em>click a run to time-travel to that version</em>
  <div id="strip" style="margin:.6em 0">
   <button id="loadStrip" type="button">load history strip</button>
   <input id="scrub" type="range" min="0" max="0" value="0"
    style="display:none;width:100%">
   <span id="stripLabel"></span>
  </div>
  <pre id="txt"></pre></div>
</div>
<script>
const DOC = "__DOC__";
// History strip: ONE request -> the server materializes every snapshot
// in a single batched device call (texts_at_versions); scrubbing is then
// instant and offline.
let STRIP = null;
document.getElementById("loadStrip").addEventListener("click", async () => {
  const r = await fetch(`/doc/${DOC}/history`, {
    method: "POST", body: JSON.stringify({n: 24})});
  STRIP = (await r.json()).snapshots;
  const s = document.getElementById("scrub");
  s.max = STRIP.length - 1; s.value = STRIP.length - 1;
  s.style.display = "block";
  showStrip(STRIP.length - 1);
});
document.getElementById("scrub").addEventListener("input",
  e => showStrip(+e.target.value));
function showStrip(i){
  if (!STRIP || !STRIP[i]) return;
  document.getElementById("stripLabel").textContent =
    `version ${STRIP[i].lv} (${i + 1}/${STRIP.length})`;
  document.getElementById("txt").textContent = STRIP[i].text;
}
const NS = "http://www.w3.org/2000/svg";
fetch(`/doc/${DOC}/graph`).then(r => r.json()).then(g => {
  const svg = document.getElementById("g");
  const agents = [...new Set(g.runs.map(r => r.agent))];
  const laneW = 150, rowH = 38;
  svg.setAttribute("width", Math.max(640, agents.length * laneW + 40));
  svg.setAttribute("height", g.runs.length * rowH + 50);
  const ctr = {};
  agents.forEach((a, i) => {
    const t = document.createElementNS(NS, "text");
    t.setAttribute("x", 20 + i * laneW); t.setAttribute("y", 22);
    t.textContent = a; t.setAttribute("font-weight", "600");
    svg.appendChild(t);
  });
  // A parent LV can point mid-run (editing at a stale version): resolve
  // it to the run containing it, not just run ends.
  const runOf = p => g.runs.findIndex(r => r.start <= p && p < r.end);
  g.runs.forEach((r, i) => {
    const x = 20 + agents.indexOf(r.agent) * laneW, y = 36 + i * rowH;
    ctr[i] = [x + 55, y + 11];
    for (const p of r.parents) {
      const pi = runOf(p);
      if (!(pi in ctr)) continue;
      const [px, py] = ctr[pi];
      const e = document.createElementNS(NS, "path");
      e.setAttribute("d", `M${px},${py}C${px},${y - 8} ${x + 55},${py + 16}` +
                          ` ${x + 55},${y}`);
      e.setAttribute("fill", "none"); e.setAttribute("stroke", "#999");
      svg.appendChild(e);
    }
    const grp = document.createElementNS(NS, "g");
    grp.setAttribute("class", "run");
    const b = document.createElementNS(NS, "rect");
    b.setAttribute("x", x); b.setAttribute("y", y);
    b.setAttribute("width", 110); b.setAttribute("height", 22);
    b.setAttribute("rx", 5); b.setAttribute("fill", "#fff");
    b.setAttribute("stroke", "#888");
    const t = document.createElementNS(NS, "text");
    t.setAttribute("x", x + 6); t.setAttribute("y", y + 15);
    t.setAttribute("font-size", "12");
    t.textContent = `[${r.start}..${r.end})`;
    grp.appendChild(b); grp.appendChild(t);
    grp.addEventListener("click", async () => {
      const resp = await fetch(`/doc/${DOC}/at`, {
        method: "POST", body: JSON.stringify({lv: r.end - 1})});
      document.getElementById("txt").textContent = (await resp.json()).text;
    });
    svg.appendChild(grp);
  });
});
</script>
"""

# In-browser CRDT PEER (reference: wiki/client/dt_doc.ts:40-171 — the
# wiki app runs the full CRDT in the browser via WASM; this page runs a
# compact JS engine instead, since wasm bindings are descoped — Python is
# the binding, SURVEY §7). Unlike EDITOR_HTML's positional "dumb client",
# this client owns a real oplog: it edits OFFLINE, merges remote ops
# LOCALLY with the same YjsMod rules as the Python/C++/device engines
# (integrate, merge.rs:154-278: top-row break / bottom-row skip /
# same-gap right-origin comparison with the scanning rollback, agent-name
# then seq tie-break), and exchanges ORIGINAL ops (position + explicit
# parent versions) with the server — positions are never transformed by
# the server for this client.
CRDT_HTML = """<!doctype html>
<meta charset="utf-8"><title>crdt: __DOC__</title>
<style>
 body{font:15px system-ui;margin:2em auto;max-width:52em;color:#222}
 textarea{width:100%;height:22em;font:14px/1.5 ui-monospace,monospace;
  padding:1em;border:1px solid #bbb;border-radius:8px;box-sizing:border-box}
 #st{color:#667;font-size:13px;margin-top:.5em}
 label{font-size:13px}
</style>
<h2>__DOC__ <span style="font-size:13px;color:#888">(in-browser CRDT
peer)</span></h2>
<textarea id="t" spellcheck="false"></textarea>
<div><label><input type="checkbox" id="off"> work offline</label></div>
<div id="st">starting…</div>
<script>
const DOC = "__DOC__";
const AGENT = "peer-" + Math.random().toString(36).slice(2, 8);
const ta = document.getElementById("t"), st = document.getElementById("st");
const offBox = document.getElementById("off");

// ---- the engine: a unit-op text CRDT ---------------------------------
// ops: [{agent, seq, parents:[[a,s]...], kind:'ins'|'del', pos, ch}]
// GENERATED at import time from diamond_types_tpu/tools/crdt_replay_src.py
// (the same Python source the fuzz + golden-vector suites execute) via
// tools/py2js.py — there is no hand-written copy to drift. Convergence =
// the same YjsMod order as every other engine in this repo; replay is an
// O(n^2) full recompute — fine for interactive docs, and it keeps this
// client auditable against the reference semantics.
__ENGINE_JS__
// ---- client bookkeeping -----------------------------------------------
const eng = {
  ops: [], byKey: new Map(),            // "a:s" -> op index
  nextSeq: 0, unpushed: 0,              // our own op bookkeeping
  frontier: [],                         // [[agent, seq]...] local heads
};

function addOp(op) {
  if (eng.byKey.has(op_key(op.agent, op.seq))) return false;
  eng.byKey.set(op_key(op.agent, op.seq), eng.ops.length);
  eng.ops.push(op);
  return true;
}

function localOp(kind, pos, ch) {
  const op = {agent: AGENT, seq: eng.nextSeq++, parents: eng.frontier,
              kind, pos, ch};
  addOp(op);
  eng.frontier = [[AGENT, op.seq]];
  eng.unpushed++;
  return op;
}

// ---- UI + sync --------------------------------------------------------
let shadow = "";

function onInput() {
  const now = ta.value;
  if (now === shadow) return;
  // Diff over CODE POINTS: positions on the wire are code points, and a
  // raw UTF-16 index loop would push lone surrogate halves as op
  // content for astral chars (which the server rejects).
  const a = Array.from(shadow), b = Array.from(now);
  let p = 0, oe = a.length, ne = b.length;
  while (p < oe && p < ne && a[p] === b[p]) p++;
  while (oe > p && ne > p && a[oe - 1] === b[ne - 1]) { oe--; ne--; }
  // unit deletes: removing [p, oe) one char at a time — each removal
  // shifts the next target into position p, so every unit deletes at p
  for (let x = p; x < oe; x++) localOp("del", p, null);
  for (let x = p; x < ne; x++) localOp("ins", x, b[x]);
  shadow = now;
  st.textContent = "local edit (" + eng.unpushed + " unsynced)";
}

function rerender() {
  const text = replay(eng.ops);
  if (text === null) return;
  const cur = ta.selectionStart;
  shadow = text;
  if (ta.value !== text) {
    ta.value = text;
    ta.setSelectionRange(cur, cur);
  }
}

async function syncOnce() {
  if (offBox.checked) return;
  const have = {};
  for (const op of eng.ops) {
    have[op.agent] = Math.max(have[op.agent] || 0, op.seq + 1);
  }
  const push = [];
  for (const op of eng.ops) {
    if (op.agent === AGENT && op.seq >= eng.nextSeq - eng.unpushed) {
      push.push({agent: op.agent, seq: op.seq, parents: op.parents,
                 kind: op.kind, pos: op.pos,
                 ...(op.kind === "ins" ? {content: op.ch} : {len: 1})});
    }
  }
  try {
    const r = await fetch(`/doc/${DOC}/ops`, {method: "POST",
      body: JSON.stringify({have, push})}).then(r => r.json());
    // ops typed while the request was in flight incremented unpushed
    // AFTER `push` was built — subtract only what this round sent, or
    // the in-flight edits would be orphaned forever
    eng.unpushed -= push.length;
    let fresh = 0;
    for (const row of r.ops) {
      // expand run rows into unit ops (chained parents within the run);
      // CODE POINTS, not UTF-16 units — indexing row.content by unit
      // would split astral chars into lone-surrogate ops with
      // over-counted seqs (ops and positions are code-point-addressed
      // everywhere on the wire)
      const chars = row.kind === "ins" ? Array.from(row.content) : null;
      const units = row.kind === "ins" ? chars.length : row.len;
      for (let u = 0; u < units; u++) {
        // fwd deletes repeat at the span start (each removal shifts the
        // next char in); reverse (backspace) runs walk end-1 downward
        const dpos = row.fwd ? row.pos : row.pos + (units - 1 - u);
        const op = {agent: row.agent, seq: row.seq + u,
          parents: u === 0 ? row.parents : [[row.agent, row.seq + u - 1]],
          kind: row.kind,
          pos: row.kind === "ins" ? row.pos + u : dpos,
          ch: row.kind === "ins" ? chars[u] : null};
        if (addOp(op)) fresh++;
      }
    }
    if (fresh) {
      // remote heads join our frontier
      const f = new Map(eng.frontier.map(([a, s]) => [a, s]));
      for (const [a, s] of r.version) {
        if (a !== AGENT) f.set(a, Math.max(f.get(a) ?? -1, s));
      }
      eng.frontier = [...f.entries()];
      rerender();
    }
    st.textContent = `synced · ${eng.ops.length} ops · ` +
      (offBox.checked ? "offline" : "online");
  } catch (e) {
    st.textContent = "sync failed: " + e;
  }
}

ta.addEventListener("input", onInput);
setInterval(syncOnce, 1200);
syncOnce().then(rerender);
</script>
"""

def _generate_engine_js() -> str:
    """Transpile the single-source engine (crdt_replay_src.py) to the JS
    shipped in the page. Raises UnsupportedConstruct at import time if
    the source leaves the transpilable subset — the generation-time
    assertion that replaced the old sha256 pin (VERDICT r4 #5): the
    emitted JS is never stored, so it cannot be hand-edited out of sync
    with the Python the fuzz/golden suites execute."""
    from . import crdt_replay_src
    from .py2js import transpile_module
    return transpile_module(crdt_replay_src)


_ENGINE_JS = _generate_engine_js()
if "__ENGINE_JS__" not in CRDT_HTML:
    # a real exception, not an assert: under python -O an assert would
    # vanish and the editor page would ship with no engine at all
    raise RuntimeError("CRDT_HTML engine injection marker missing")
CRDT_HTML = CRDT_HTML.replace("__ENGINE_JS__", _ENGINE_JS)


def crdt_engine_js() -> str:
    """The in-browser CRDT ENGINE as shipped — the transpiled output of
    tools/crdt_replay_src.py (the golden conformance fixture pins the
    SOURCE module; regenerate with python -m tests.gen_crdt_golden after
    any engine edit)."""
    return _ENGINE_JS
