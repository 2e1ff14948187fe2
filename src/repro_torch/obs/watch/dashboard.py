"""Observatory dashboard: one self-contained HTML file, no server.

:func:`collect_data` assembles a single JSON blob from the pieces the
repo already produces — ``obs.summary()`` (per-tier residual roll-ups,
alert counters, metric snapshot), the telemetry accuracy report
(per-algorithm mean/max rel-err), the watch/SLO watcher summaries, and
the bench history.  :func:`render_dashboard` embeds that blob verbatim
into a static template (inline CSS + vanilla JS, zero external
requests) that renders:

* stat tiles — paired spans, overall mean rel-err, active alerts;
* the per-algorithm accuracy table (the paper's Tables II-V view);
* per-tier rel-err residual histograms;
* SLO burn-rate timelines with the firing thresholds drawn in;
* bench-history sparklines (one per tracked metric, per machine);
* the alert feed (drift / watch / SLO burn, newest first).

The data contract is §11 of DESIGN.md: everything the JS reads lives
under the single ``window.DATA`` object, so any other consumer (CI, a
notebook) can reuse :func:`collect_data` output directly.  Generation is
pure string assembly — rendering a 10k-span session is bounded by the
``json.dumps`` of its summary, well under the 1 s bench gate.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

from ... import paths


#: cap on sparkline series per bench — the flattener can emit dozens of
#: leaves; the dashboard shows the first N alphabetically and says so.
MAX_SPARKS_PER_BENCH = 12


def _maybe_summary(obj):
    if obj is None or isinstance(obj, dict):
        return obj
    return obj.summary()


def history_series(runs: Sequence, max_per_bench: int = MAX_SPARKS_PER_BENCH,
                   ) -> dict:
    """Group :class:`~repro_torch.obs.watch.history.BenchRun` rows into
    sparkline series: bench -> metric -> [{t, commit, v}] (time-sorted,
    metrics with <2 points dropped — a sparkline needs a trajectory)."""
    benches: dict = {}
    for run in sorted(runs, key=lambda r: r.timestamp):
        b = benches.setdefault(run.bench, {})
        for metric, value in run.metrics.items():
            b.setdefault(metric, []).append(
                {"t": run.timestamp, "commit": run.commit[:9],
                 "v": float(value)})
    out = {}
    for bench, metrics in sorted(benches.items()):
        keep = {m: pts for m, pts in sorted(metrics.items())
                if len(pts) >= 2}
        dropped = len(keep) - max_per_bench
        out[bench] = {
            "metrics": dict(list(keep.items())[:max_per_bench]),
            "dropped_metrics": max(0, dropped),
        }
    return out


def collect_data(summary: Optional[dict] = None,
                 accuracy: Optional[dict] = None,
                 watch=None, slo=None,
                 history: Optional[Sequence] = None,
                 title: str = "repro observatory") -> dict:
    """Assemble the dashboard data blob (§11 data contract).

    Every argument is optional: ``summary`` defaults to a live
    ``obs.summary()`` call; ``watch``/``slo`` accept watcher objects or
    their ``summary()`` dicts; ``history`` is a sequence of
    :class:`BenchRun` (or an already-grouped dict)."""
    if summary is None:
        from ..summary import summary as obs_summary
        summary = obs_summary()
    if history is None:
        hist = None
    elif isinstance(history, dict):
        hist = history
    else:
        hist = history_series(history)
    return {
        "title": title,
        "generated_unix": time.time(),
        "obs": summary,
        "accuracy": accuracy,
        "watch": _maybe_summary(watch),
        "slo": _maybe_summary(slo),
        "history": hist,
    }


def render_dashboard(data: dict) -> str:
    """The data blob -> a single HTML document (string)."""
    blob = json.dumps(data, sort_keys=True).replace("</", "<\\/")
    return _TEMPLATE.replace("__DATA__", blob)


def save_dashboard(path: Optional[str] = None,
                   data: Optional[dict] = None, **collect_kwargs) -> str:
    """Render and write the dashboard (default: ``dashboard.html`` under
    ``artifacts/obs_torch/``, ``repro_torch.paths``); returns the path."""
    if data is None:
        data = collect_data(**collect_kwargs)
    if path is None:
        path = os.path.join(paths.obs_dir(), "dashboard.html")
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(render_dashboard(data))
    return path


# The template keeps to the repo's chart conventions: text never wears a
# series color, marks are thin (2px lines, slim rounded-top bars), grids
# recessive, light/dark from one set of CSS custom properties, and every
# mark carries a native <title> tooltip so the numbers are hoverable
# without any dependency.
_TEMPLATE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>repro observatory</title>
<style>
:root {
  --surface: #fcfcfb; --ink: #0b0b0b; --ink2: #52514e; --ink3: #898781;
  --grid: #e1e0d9; --card: #ffffff; --edge: #e1e0d9;
  --s1: #2a78d6; --s2: #898781;
  --good: #0ca30c; --warn: #fab219; --serious: #ec835a; --crit: #d03b3b;
}
@media (prefers-color-scheme: dark) {
  :root {
    --surface: #1a1a19; --ink: #ffffff; --ink2: #c3c2b7; --ink3: #898781;
    --grid: #2c2c2a; --card: #222221; --edge: #2c2c2a;
    --s1: #3987e5;
  }
}
* { box-sizing: border-box; }
body {
  margin: 0; padding: 24px; background: var(--surface); color: var(--ink);
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
}
h1 { font-size: 18px; font-weight: 650; margin: 0 0 2px; }
h2 { font-size: 13px; font-weight: 600; color: var(--ink2);
     text-transform: uppercase; letter-spacing: .04em; margin: 28px 0 10px; }
.sub { color: var(--ink3); font-size: 12px; margin-bottom: 18px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--card); border: 1px solid var(--edge);
        border-radius: 8px; padding: 12px 16px; min-width: 150px; }
.tile .k { font-size: 12px; color: var(--ink2); }
.tile .v { font-size: 24px; font-weight: 650;
           font-variant-numeric: tabular-nums; }
.tile .d { font-size: 11px; color: var(--ink3); }
.cards { display: flex; flex-wrap: wrap; gap: 12px; }
.card { background: var(--card); border: 1px solid var(--edge);
        border-radius: 8px; padding: 12px 16px; }
.card .t { font-size: 12px; font-weight: 600; color: var(--ink2);
           margin-bottom: 6px; }
table { border-collapse: collapse; background: var(--card);
        border: 1px solid var(--edge); border-radius: 8px; }
th, td { padding: 6px 14px; text-align: right; font-size: 13px; }
th { color: var(--ink2); font-weight: 600; border-bottom: 1px solid var(--edge); }
td { font-variant-numeric: tabular-nums; border-bottom: 1px solid var(--grid); }
tr:last-child td { border-bottom: none; }
th:first-child, td:first-child { text-align: left;
                                 font-variant-numeric: normal; }
.dot { display: inline-block; width: 8px; height: 8px; border-radius: 50%;
       margin-right: 6px; vertical-align: baseline; }
.alerts { list-style: none; margin: 0; padding: 0; }
.alerts li { background: var(--card); border: 1px solid var(--edge);
             border-radius: 8px; padding: 8px 12px; margin-bottom: 6px;
             font-size: 13px; }
.alerts .when { color: var(--ink3); font-size: 12px; margin-left: 8px;
                font-variant-numeric: tabular-nums; }
.badge { font-weight: 650; margin-right: 8px; }
.empty { color: var(--ink3); font-size: 13px; }
.legend { font-size: 12px; color: var(--ink2); margin-top: 4px; }
.legend .sw { display: inline-block; width: 14px; height: 3px;
              border-radius: 2px; margin: 0 5px 2px 12px;
              vertical-align: middle; }
svg text { fill: var(--ink3); font: 10px system-ui, sans-serif; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
</style>
</head>
<body>
<h1 id="title"></h1>
<div class="sub" id="sub"></div>
<div class="tiles" id="tiles"></div>
<div id="sections"></div>
<script>
window.DATA = __DATA__;
(function () {
"use strict";
var D = window.DATA, css = getComputedStyle(document.documentElement);
function v(name) { return css.getPropertyValue(name).trim(); }
var C = { s1: v('--s1'), s2: v('--s2'), grid: v('--grid'),
          good: v('--good'), warn: v('--warn'), serious: v('--serious'),
          crit: v('--crit'), ink3: v('--ink3') };
function esc(s) { return String(s).replace(/&/g, '&amp;')
  .replace(/</g, '&lt;').replace(/>/g, '&gt;').replace(/"/g, '&quot;'); }
function fmt(x, d) {
  if (x === null || x === undefined || Number.isNaN(x)) return '–';
  if (typeof x !== 'number') return esc(x);
  var a = Math.abs(x);
  if (d === undefined) d = a >= 100 ? 0 : a >= 1 ? 2 : 4;
  if (a >= 1e6 || (a > 0 && a < 1e-3)) return x.toExponential(2);
  return x.toFixed(d);
}
function pct(x) {
  return (x === null || x === undefined || Number.isNaN(x))
    ? '–' : (100 * x).toFixed(1) + '%';
}
function el(html) {
  var t = document.createElement('template');
  t.innerHTML = html.trim(); return t.content.firstChild;
}
function section(title) {
  var root = document.getElementById('sections');
  root.appendChild(el('<h2>' + esc(title) + '</h2>'));
  var box = el('<div class="cards"></div>');
  root.appendChild(box); return box;
}
function tile(k, val, detail) {
  document.getElementById('tiles').appendChild(el(
    '<div class="tile"><div class="k">' + esc(k) + '</div>' +
    '<div class="v">' + val + '</div>' +
    (detail ? '<div class="d">' + esc(detail) + '</div>' : '') + '</div>'));
}
function errColor(e) {
  if (e === null || e === undefined) return C.ink3;
  return e < 0.25 ? C.good : e < 0.5 ? C.warn : e < 1 ? C.serious : C.crit;
}

// ---- header + stat tiles ----
document.getElementById('title').textContent = D.title || 'repro observatory';
document.getElementById('sub').textContent = 'generated ' +
  new Date(1000 * (D.generated_unix || 0)).toISOString() +
  ' · spans: ' + ((D.obs && D.obs.n_spans) || 0);
var obs = D.obs || {}, tiers = obs.tiers || {};
var paired = 0, nerr = 0;
Object.keys(tiers).forEach(function (t) {
  paired += tiers[t].n_paired || 0; nerr += tiers[t].n_errors || 0;
});
var overall = D.accuracy && D.accuracy.overall;
var alertTotal = 0, ak = obs.alerts || {};
Object.keys(ak).forEach(function (k) { alertTotal += ak[k]; });
tile('paired spans', String(paired), nerr + ' span errors');
tile('mean rel err', overall ? pct(overall.mean_rel_err) : '–',
     overall ? ('max ' + pct(overall.max_rel_err)) : 'no accuracy report');
tile('alerts', String(alertTotal),
     Object.keys(ak).sort().map(function (k) {
       return k + ':' + ak[k]; }).join(' ') || 'none');
var firingRules = [];
if (D.slo && D.slo.rules) Object.keys(D.slo.rules).forEach(function (r) {
  if (D.slo.rules[r].firing) firingRules.push(r); });
tile('SLO burn', firingRules.length ? 'FIRING' : 'ok',
     firingRules.join(', ') || 'no rule firing');

// ---- per-algorithm accuracy table ----
if (D.accuracy && D.accuracy.ops && Object.keys(D.accuracy.ops).length) {
  var box = section('model accuracy by algorithm');
  var rows = Object.keys(D.accuracy.ops).sort().map(function (op) {
    var r = D.accuracy.ops[op];
    return '<tr><td><span class="dot" style="background:' +
      errColor(r.mean_rel_err) + '"></span>' + esc(op) + '</td><td>' +
      r.n_rows + '</td><td>' + pct(r.mean_rel_err) + '</td><td>' +
      pct(r.max_rel_err) + '</td><td>' +
      fmt(r.mean_abs_log_ratio, 3) + '</td></tr>';
  }).join('');
  var ov = D.accuracy.overall || {};
  box.appendChild(el('<table><thead><tr><th>algorithm</th><th>rows</th>' +
    '<th>mean rel err</th><th>max rel err</th><th>mean |log ratio|</th>' +
    '</tr></thead><tbody>' + rows +
    '<tr><td><b>overall</b></td><td>' + (ov.n_rows || 0) + '</td><td>' +
    pct(ov.mean_rel_err) + '</td><td>' + pct(ov.max_rel_err) +
    '</td><td>' + fmt(ov.mean_abs_log_ratio, 3) + '</td></tr>' +
    '</tbody></table>'));
}

// ---- per-tier residual histograms ----
function histSVG(bounds, counts) {
  var W = 260, H = 90, pad = 16, n = counts.length;
  var bw = Math.min(24, Math.floor((W - 2 * pad) / Math.max(n, 1)) - 2);
  var max = Math.max.apply(null, counts.concat([1]));
  var bars = '';
  for (var i = 0; i < n; i++) {
    var h = Math.round((H - 28) * counts[i] / max);
    var x = pad + i * (bw + 2), y = H - 14 - h;
    var lab = (i ? '[' + bounds[i - 1] + ', ' : '[0, ') + bounds[i] + ')';
    bars += '<rect x="' + x + '" y="' + y + '" width="' + bw +
      '" height="' + Math.max(h, counts[i] ? 2 : 0) + '" rx="4" fill="' +
      C.s1 + '"><title>rel err ' + esc(lab) + ': ' + counts[i] +
      '</title></rect>';
    bars += '<text x="' + (x + bw / 2) + '" y="' + (H - 3) +
      '" text-anchor="middle">' + esc(String(bounds[i])) + '</text>';
  }
  return '<svg width="' + W + '" height="' + H + '" role="img">' +
    '<line class="axis" x1="' + pad + '" y1="' + (H - 14) + '" x2="' +
    (W - pad) + '" y2="' + (H - 14) + '"/>' + bars + '</svg>';
}
var tierNames = Object.keys(tiers).sort();
if (tierNames.length) {
  var hb = section('rel-err residual histograms (per tier)');
  tierNames.forEach(function (t) {
    var ti = tiers[t], h = ti.rel_err_hist || {};
    var counts = h.counts || [], total = counts.reduce(
      function (a, b) { return a + b; }, 0);
    var body = total
      ? histSVG(h.bounds || [], counts)
      : '<div class="empty">no paired spans</div>';
    hb.appendChild(el('<div class="card"><div class="t">' + esc(t) +
      ' · mean ' + pct(ti.mean_rel_err) + ' · max ' + pct(ti.max_rel_err) +
      '</div>' + body + '</div>'));
  });
}

// ---- SLO burn-rate timelines ----
function burnSVG(pts, rule) {
  var W = 420, H = 120, padL = 34, padR = 8, padT = 8, padB = 16;
  var ts = pts.map(function (p) { return p.t; });
  var t0 = Math.min.apply(null, ts), t1 = Math.max.apply(null, ts);
  if (t1 <= t0) t1 = t0 + 1;
  var ymax = Math.max(rule.fast_burn_threshold * 1.2, 1);
  pts.forEach(function (p) {
    ymax = Math.max(ymax, p.fast, p.slow); });
  function X(t) { return padL + (W - padL - padR) * (t - t0) / (t1 - t0); }
  function Y(y) { return padT + (H - padT - padB) * (1 - y / ymax); }
  function path(key) {
    return pts.map(function (p, i) {
      return (i ? 'L' : 'M') + X(p.t).toFixed(1) + ' ' +
        Y(p[key]).toFixed(1);
    }).join('');
  }
  var marks = '';
  pts.forEach(function (p) {
    if (p.firing) marks += '<circle cx="' + X(p.t).toFixed(1) + '" cy="' +
      Y(p.fast).toFixed(1) + '" r="4" fill="' + C.crit +
      '" stroke="var(--card)" stroke-width="2"><title>firing at t=' +
      fmt(p.t, 1) + 's (fast ' + fmt(p.fast, 1) + 'x, slow ' +
      fmt(p.slow, 1) + 'x)</title></circle>';
  });
  var thr = '';
  [['fast_burn_threshold', C.crit], ['slow_burn_threshold', C.warn]]
    .forEach(function (td) {
      var y = Y(rule[td[0]]);
      if (y > padT && y < H - padB)
        thr += '<line x1="' + padL + '" y1="' + y.toFixed(1) + '" x2="' +
          (W - padR) + '" y2="' + y.toFixed(1) + '" stroke="' + td[1] +
          '" stroke-width="1" stroke-dasharray="4 3" opacity="0.7"/>';
    });
  return '<svg width="' + W + '" height="' + H + '" role="img">' +
    '<line class="axis" x1="' + padL + '" y1="' + (H - padB) + '" x2="' +
    (W - padR) + '" y2="' + (H - padB) + '"/>' +
    '<text x="2" y="' + (padT + 8) + '">' + fmt(ymax, 0) + 'x</text>' +
    '<text x="2" y="' + (H - padB) + '">0</text>' + thr +
    '<path d="' + path('slow') + '" fill="none" stroke="' + C.s2 +
    '" stroke-width="2"/>' +
    '<path d="' + path('fast') + '" fill="none" stroke="' + C.s1 +
    '" stroke-width="2"/>' + marks + '</svg>';
}
if (D.slo && D.slo.timeline && D.slo.timeline.length) {
  var sb = section('SLO burn rate (x budget)');
  var byRule = {};
  D.slo.timeline.forEach(function (p) {
    (byRule[p.rule] = byRule[p.rule] || []).push(p); });
  Object.keys(byRule).sort().forEach(function (name) {
    var rule = (D.slo.rules || {})[name] || {};
    sb.appendChild(el('<div class="card"><div class="t">' + esc(name) +
      ' (objective ' + pct(rule.objective) + ')' +
      (rule.firing ? ' — FIRING' : '') + '</div>' +
      burnSVG(byRule[name], rule) +
      '<div class="legend"><span class="sw" style="background:' + C.s1 +
      '"></span>fast ' + fmt(rule.fast_window_s, 0) +
      's<span class="sw" style="background:' + C.s2 + '"></span>slow ' +
      fmt(rule.slow_window_s, 0) + 's</div></div>'));
  });
}

// ---- bench-history sparklines ----
function sparkSVG(pts) {
  var W = 150, H = 34, pad = 3;
  var vs = pts.map(function (p) { return p.v; });
  var lo = Math.min.apply(null, vs), hi = Math.max.apply(null, vs);
  if (hi <= lo) { hi = lo + 1; lo = lo - 1; }
  function X(i) { return pad + (W - 2 * pad) * i / (pts.length - 1); }
  function Y(val) { return pad + (H - 2 * pad) * (1 - (val - lo) / (hi - lo)); }
  var d = pts.map(function (p, i) {
    return (i ? 'L' : 'M') + X(i).toFixed(1) + ' ' + Y(p.v).toFixed(1);
  }).join('');
  var last = pts[pts.length - 1];
  return '<svg width="' + W + '" height="' + H + '" role="img">' +
    '<path d="' + d + '" fill="none" stroke="' + C.s1 +
    '" stroke-width="2"/>' +
    '<circle cx="' + X(pts.length - 1).toFixed(1) + '" cy="' +
    Y(last.v).toFixed(1) + '" r="3" fill="' + C.s1 +
    '"><title>' + esc(last.commit || '') + ': ' + fmt(last.v) +
    '</title></circle></svg>';
}
if (D.history && Object.keys(D.history).length) {
  var hb2 = section('bench history');
  Object.keys(D.history).sort().forEach(function (bench) {
    var metrics = D.history[bench].metrics || {};
    var names = Object.keys(metrics).sort();
    if (!names.length) return;
    var rows = names.map(function (m) {
      var pts = metrics[m], last = pts[pts.length - 1];
      return '<tr><td>' + esc(m) + '</td><td>' + sparkSVG(pts) +
        '</td><td>' + fmt(last.v) + '</td></tr>';
    }).join('');
    var note = D.history[bench].dropped_metrics
      ? '<div class="legend">+' + D.history[bench].dropped_metrics +
        ' more metrics tracked</div>' : '';
    hb2.appendChild(el('<div class="card"><div class="t">' + esc(bench) +
      '</div><table><thead><tr><th>metric</th><th>trend</th>' +
      '<th>latest</th></tr></thead><tbody>' + rows + '</tbody></table>' +
      note + '</div>'));
  });
}

// ---- alert feed ----
var feed = [];
if (D.watch && D.watch.firings) D.watch.firings.forEach(function (f) {
  feed.push({ kind: 'watch/' + f.detector, what: f.series + ' value ' +
    fmt(f.value) + ' vs ' + f.stat + ' ' + fmt(f.threshold),
    sev: 'serious', at: f.n_obs + ' obs' });
});
if (D.slo && D.slo.alerts) D.slo.alerts.forEach(function (a) {
  feed.push({ kind: 'slo_burn/' + a.rule, what: 'fast ' +
    fmt(a.fast_burn, 1) + 'x / slow ' + fmt(a.slow_burn, 1) +
    'x budget', sev: 'critical', at: 't=' + fmt(a.clock, 1) + 's' });
});
var root = document.getElementById('sections');
root.appendChild(el('<h2>alert feed</h2>'));
if (feed.length) {
  var ul = el('<ul class="alerts"></ul>');
  feed.slice(-40).reverse().forEach(function (f) {
    var col = f.sev === 'critical' ? C.crit : C.serious;
    ul.appendChild(el('<li><span class="badge" style="color:' + col +
      '">&#9650; ' + esc(f.kind) + '</span>' + esc(f.what) +
      '<span class="when">' + esc(f.at) + '</span></li>'));
  });
  root.appendChild(ul);
} else {
  root.appendChild(el('<div class="empty">no alerts recorded</div>'));
}
})();
</script>
</body>
</html>
"""
