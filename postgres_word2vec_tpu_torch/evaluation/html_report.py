"""Interactive HTML reports — self-contained, zero-dependency.

Parity target: the reference's plotly-offline reporting layer
(/root/reference/evaluation/evaluation_utils.py:240-344 — ``plot_graph`` /
``plot_scatter_graph`` emit standalone interactive HTML). This module
produces the same artifact class without plotly (not in the image, zero
egress): one self-contained page per report with SVG line/scatter charts,
a crosshair + all-series tooltip, a legend, a table view, and light/dark
theming.

Chart method + palette follow the bundled dataviz procedure: categorical
hues in the documented fixed order (validated for adjacent-pair forms in
both modes — see the skill's reference palette), 2px line marks, ≥8px
markers, recessive grid, one y-axis, values-lead tooltips, labels
inserted with ``textContent`` (series names are data, never markup).

The port's own copy of ``postgres_word2vec_tpu/evaluation/html_report.py``
(it takes ``METHOD_NAMES`` from the port's :mod:`plots`).

Usage::

    from postgres_word2vec_tpu_torch.evaluation.html_report import (
        Figure, Series, write_html_report)
    fig = Figure(title="time-precision tradeoff",
                 xlabel="time (ms/query)", ylabel="recall@10", xlog=True,
                 series=[Series("pq", xs, ys), ...])
    write_html_report("reports/tradeoff.html", [fig],
                      title="IVPQ time/precision @3M")
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

#: categorical palette, documented fixed order (light, dark) — the
#: validated reference instance of the dataviz skill; adjacent-pair safe
#: in both modes. Do NOT re-order or cycle.
_PALETTE = [
    ("#2a78d6", "#3987e5"),   # blue
    ("#eb6834", "#d95926"),   # orange
    ("#1baf7a", "#199e70"),   # aqua
    ("#eda100", "#c98500"),   # yellow
    ("#e87ba4", "#d55181"),   # magenta
    ("#008300", "#008300"),   # green
    ("#4a3aa7", "#9085e9"),   # violet
    ("#e34948", "#e66767"),   # red
]


@dataclasses.dataclass
class Series:
    name: str
    x: Sequence[float]
    y: Sequence[float]
    #: optional per-point hover annotations (e.g. "alpha=200")
    labels: Sequence[str] | None = None


@dataclasses.dataclass
class Figure:
    title: str
    xlabel: str
    ylabel: str
    series: list[Series]
    xlog: bool = False
    #: "line" (sorted by x, connected) or "scatter" (points only)
    kind: str = "line"

    def to_json(self) -> dict:
        if len(self.series) > len(_PALETTE):
            raise ValueError(
                f"{len(self.series)} series exceeds the validated "
                f"{len(_PALETTE)}-slot palette — fold into 'Other' or "
                "split the figure")
        return {
            "title": self.title, "xlabel": self.xlabel,
            "ylabel": self.ylabel, "xlog": self.xlog, "kind": self.kind,
            "series": [
                {"name": s.name,
                 "x": [float(v) for v in s.x],
                 "y": [float(v) for v in s.y],
                 "labels": list(s.labels) if s.labels is not None else None,
                 "light": _PALETTE[i][0], "dark": _PALETTE[i][1]}
                for i, s in enumerate(self.series)],
        }


_CSS = """
.viz-root { color-scheme: light;
  --surface-1:#fcfcfb; --surface-2:#f4f3f0;
  --text-primary:#0b0b0b; --text-secondary:#52514e; --text-muted:#8a8983;
  --grid:#e4e3df; --hairline:#c9c8c2; }
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root { color-scheme: dark;
    --surface-1:#1a1a19; --surface-2:#242423;
    --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#8a897f;
    --grid:#32322f; --hairline:#4a4a45; } }
:root[data-theme="dark"] .viz-root { color-scheme: dark;
  --surface-1:#1a1a19; --surface-2:#242423;
  --text-primary:#ffffff; --text-secondary:#c3c2b7; --text-muted:#8a897f;
  --grid:#32322f; --hairline:#4a4a45; }
.viz-root { background: var(--surface-1); color: var(--text-primary);
  font: 14px/1.45 system-ui, sans-serif; margin: 0; padding: 24px; }
.viz-root h1 { font-size: 19px; margin: 0 0 4px; }
.viz-root .sub { color: var(--text-secondary); margin: 0 0 20px; }
.fig { margin: 0 0 36px; max-width: 860px; }
.fig h2 { font-size: 15px; margin: 0 0 2px; }
.fig .axes { color: var(--text-muted); font-size: 12px; margin: 0 0 6px; }
.fig svg { display: block; width: 100%; height: auto; }
.fig .grid line { stroke: var(--grid); stroke-width: 1; }
.fig .axis text { fill: var(--text-secondary); font-size: 11px; }
.fig .axis line { stroke: var(--hairline); }
.fig path.ln { fill: none; stroke-width: 2; }
.fig circle.pt { stroke: var(--surface-1); stroke-width: 2; }
.fig .hair { stroke: var(--hairline); stroke-width: 1; visibility: hidden; }
.legend { display: flex; flex-wrap: wrap; gap: 14px; margin: 8px 0 0;
  color: var(--text-secondary); font-size: 12px; }
.legend .key { display: inline-block; width: 16px; height: 2px;
  vertical-align: middle; margin-right: 5px; }
.tip { position: fixed; pointer-events: none; visibility: hidden;
  background: var(--surface-2); border: 1px solid var(--hairline);
  border-radius: 6px; padding: 8px 10px; font-size: 12px; z-index: 10;
  color: var(--text-secondary); box-shadow: 0 2px 10px rgba(0,0,0,.15); }
.tip b { color: var(--text-primary); font-weight: 600; }
.tip .row { display: flex; align-items: center; gap: 6px; }
.tip .key { display: inline-block; width: 12px; height: 2px; }
.tbl-toggle { background: none; border: 1px solid var(--hairline);
  color: var(--text-secondary); border-radius: 5px; padding: 2px 10px;
  font-size: 12px; cursor: pointer; margin-top: 8px; }
table.viz { border-collapse: collapse; margin-top: 10px; font-size: 12px;
  color: var(--text-secondary); display: none; }
table.viz.open { display: table; }
table.viz th, table.viz td { border: 1px solid var(--grid);
  padding: 3px 9px; text-align: right; }
table.viz th { color: var(--text-primary); font-weight: 600; }
"""

_JS = r"""
(function () {
  var dark = matchMedia && matchMedia('(prefers-color-scheme: dark)');
  function seriesColor(s) { return (dark && dark.matches) ? s.dark : s.light; }
  var W = 860, H = 380, M = {l: 58, r: 140, t: 10, b: 40};
  function scale(v, d0, d1, r0, r1, log) {
    if (log) { v = Math.log10(Math.max(v, 1e-12));
               d0 = Math.log10(Math.max(d0, 1e-12));
               d1 = Math.log10(Math.max(d1, 1e-12)); }
    return r0 + (v - d0) / ((d1 - d0) || 1) * (r1 - r0);
  }
  function ticks(d0, d1, n) {
    var span = (d1 - d0) || 1, step = Math.pow(10, Math.floor(Math.log10(span / n)));
    for (var m of [5, 2, 1]) if (span / (step * m) >= n) { step *= m; break; }
    var out = [], v = Math.ceil(d0 / step) * step;
    for (; v <= d1 + 1e-9; v += step) out.push(+v.toPrecision(12));
    return out;
  }
  function fmt(v) {
    if (!isFinite(v)) return String(v);
    var a = Math.abs(v);
    if (a >= 1000) return v.toLocaleString(undefined, {maximumFractionDigits: 0});
    if (a >= 10) return v.toFixed(1).replace(/\.0$/, '');
    return v.toPrecision(3);
  }
  function el(tag, attrs) {
    var e = document.createElementNS('http://www.w3.org/2000/svg', tag);
    for (var k in attrs) e.setAttribute(k, attrs[k]);
    return e;
  }
  function render(fig, host) {
    var xs = [], ys = [];
    fig.series.forEach(function (s) { xs = xs.concat(s.x); ys = ys.concat(s.y); });
    var x0 = Math.min.apply(0, xs), x1 = Math.max.apply(0, xs);
    var y0 = Math.min(0, Math.min.apply(0, ys)), y1 = Math.max.apply(0, ys);
    if (y1 === y0) y1 = y0 + 1;
    y1 *= 1.05;
    var svg = el('svg', {viewBox: '0 0 ' + W + ' ' + H, role: 'img'});
    var X = function (v) { return scale(v, x0, x1, M.l, W - M.r, fig.xlog); };
    var Y = function (v) { return scale(v, y0, y1, H - M.b, M.t, false); };
    var grid = el('g', {class: 'grid'}), axis = el('g', {class: 'axis'});
    ticks(y0, y1, 5).forEach(function (t) {
      grid.appendChild(el('line', {x1: M.l, x2: W - M.r, y1: Y(t), y2: Y(t)}));
      var lb = el('text', {x: M.l - 8, y: Y(t) + 4, 'text-anchor': 'end'});
      lb.textContent = fmt(t); axis.appendChild(lb);
    });
    var xt = fig.xlog ? (function () {
      var out = [], p = Math.floor(Math.log10(Math.max(x0, 1e-12)));
      for (; Math.pow(10, p) <= x1 * 1.001; p++) out.push(Math.pow(10, p));
      return out.filter(function (v) { return v >= x0 * 0.999; });
    })() : ticks(x0, x1, 6);
    xt.forEach(function (t) {
      var lb = el('text', {x: X(t), y: H - M.b + 18, 'text-anchor': 'middle'});
      lb.textContent = fmt(t); axis.appendChild(lb);
      axis.appendChild(el('line', {x1: X(t), x2: X(t), y1: H - M.b,
                                   y2: H - M.b + 4}));
    });
    axis.appendChild(el('line', {x1: M.l, x2: W - M.r, y1: H - M.b, y2: H - M.b}));
    svg.appendChild(grid); svg.appendChild(axis);
    fig.series.forEach(function (s) {
      var c = seriesColor(s);
      var pts = s.x.map(function (x, i) { return [x, s.y[i], i]; })
                   .sort(function (a, b) { return a[0] - b[0]; });
      if (fig.kind === 'line' && pts.length > 1) {
        var d = pts.map(function (p, i) {
          return (i ? 'L' : 'M') + X(p[0]).toFixed(1) + ' ' + Y(p[1]).toFixed(1);
        }).join(' ');
        svg.appendChild(el('path', {class: 'ln', d: d, stroke: c}));
      }
      pts.forEach(function (p) {
        svg.appendChild(el('circle', {class: 'pt', cx: X(p[0]), cy: Y(p[1]),
                                      r: 4, fill: c}));
      });
      // direct end-label (≤4 series rule; legend still present)
      if (fig.series.length <= 4 && pts.length) {
        var last = pts[pts.length - 1];
        var lb = el('text', {x: X(last[0]) + 8, y: Y(last[1]) + 4,
                             fill: 'currentColor', 'font-size': 11});
        lb.textContent = s.name;
        lb.style.fill = 'var(--text-secondary)';
        svg.appendChild(lb);
      }
    });
    var hair = el('line', {class: 'hair', y1: M.t, y2: H - M.b});
    svg.appendChild(hair);
    host.appendChild(svg);
    var legend = document.createElement('div'); legend.className = 'legend';
    fig.series.forEach(function (s) {
      var item = document.createElement('span');
      var key = document.createElement('span'); key.className = 'key';
      key.style.background = seriesColor(s);
      item.appendChild(key);
      item.appendChild(document.createTextNode(s.name));
      legend.appendChild(item);
    });
    if (fig.series.length > 1) host.appendChild(legend);
    var tip = document.createElement('div'); tip.className = 'tip';
    document.body.appendChild(tip);
    svg.addEventListener('pointermove', function (ev) {
      var r = svg.getBoundingClientRect();
      var px = (ev.clientX - r.left) * W / r.width;
      var best = null;
      fig.series.forEach(function (s) {
        s.x.forEach(function (x) {
          var d = Math.abs(X(x) - px);
          if (!best || d < best.d) best = {d: d, x: x};
        });
      });
      if (!best) return;
      hair.setAttribute('x1', X(best.x)); hair.setAttribute('x2', X(best.x));
      hair.style.visibility = 'visible';
      while (tip.firstChild) tip.removeChild(tip.firstChild);
      var head = document.createElement('div');
      head.appendChild(document.createTextNode(fig.xlabel + ': ' + fmt(best.x)));
      tip.appendChild(head);
      fig.series.forEach(function (s) {
        var bi = -1, bd = Infinity;
        s.x.forEach(function (x, i) {
          var d = Math.abs(x - best.x);
          if (d < bd) { bd = d; bi = i; }
        });
        if (bi < 0 || bd > Math.abs(best.x) * 0.25 + 1e-9) return;
        var row = document.createElement('div'); row.className = 'row';
        var key = document.createElement('span'); key.className = 'key';
        key.style.background = seriesColor(s);
        var val = document.createElement('b');
        val.textContent = fmt(s.y[bi]);
        row.appendChild(key); row.appendChild(val);
        var name = document.createTextNode(
          ' ' + s.name + (s.labels && s.labels[bi] ? ' (' + s.labels[bi] + ')' : ''));
        row.appendChild(name);
        tip.appendChild(row);
      });
      tip.style.visibility = 'visible';
      tip.style.left = Math.min(ev.clientX + 14, innerWidth - 230) + 'px';
      tip.style.top = (ev.clientY + 14) + 'px';
    });
    svg.addEventListener('pointerleave', function () {
      tip.style.visibility = 'hidden'; hair.style.visibility = 'hidden';
    });
    // table view — identity and values reachable without hover
    var btn = document.createElement('button');
    btn.className = 'tbl-toggle'; btn.textContent = 'table view';
    var tbl = document.createElement('table'); tbl.className = 'viz';
    var hr = document.createElement('tr');
    [fig.xlabel].concat(fig.series.map(function (s) { return s.name; }))
      .forEach(function (h) {
        var th = document.createElement('th'); th.textContent = h;
        hr.appendChild(th);
      });
    tbl.appendChild(hr);
    var allx = Array.from(new Set(xs)).sort(function (a, b) { return a - b; });
    allx.forEach(function (x) {
      var tr = document.createElement('tr');
      var td = document.createElement('td'); td.textContent = fmt(x);
      tr.appendChild(td);
      fig.series.forEach(function (s) {
        var i = s.x.indexOf(x);
        var td2 = document.createElement('td');
        td2.textContent = i >= 0 ? fmt(s.y[i]) : '';
        tr.appendChild(td2);
      });
      tbl.appendChild(tr);
    });
    btn.addEventListener('click', function () { tbl.classList.toggle('open'); });
    host.appendChild(btn); host.appendChild(tbl);
  }
  var data = JSON.parse(document.getElementById('viz-data').textContent);
  data.figures.forEach(function (fig, i) {
    render(fig, document.getElementById('fig-' + i));
  });
})();
"""


def figure_from_records(records: Sequence[dict], *,
                        title: str = "kNN-join time / precision trade-off"
                        ) -> Figure:
    """Build the time-precision Figure from ``time_precision_sweep``
    records (one series per method, points hover-annotated with their
    alpha/pvf config — the reference figure's hover text,
    evaluation_utils.py:240-344)."""
    from postgres_word2vec_tpu_torch.evaluation.plots import METHOD_NAMES

    by_method: dict = {}
    for r in records:
        by_method.setdefault(r["method"], []).append(r)
    series = []
    for method, rows in sorted(by_method.items(), key=lambda kv: str(kv[0])):
        rows = sorted(rows, key=lambda r: r["precision"])
        labels = [" ".join(f"{k}={r[k]}" for k in ("alpha", "pvf")
                           if k in r) or None for r in rows]
        series.append(Series(
            METHOD_NAMES.get(method, str(method)),
            [r["precision"] for r in rows],
            [r["time_s"] for r in rows],
            labels=labels if any(labels) else None))
    return Figure(title=title, xlabel="precision@k vs exact",
                  ylabel="time (s)", series=series)


def write_html_report(path: str | Path, figures: Sequence[Figure], *,
                      title: str, subtitle: str = "") -> Path:
    """Write a standalone interactive HTML report (no network, no deps)."""
    import html as _html

    path = Path(path)
    payload = {"figures": [f.to_json() for f in figures]}
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        f"<style>{_CSS}</style></head>",
        "<body class='viz-root'>",
        f"<h1>{_html.escape(title)}</h1>",
        f"<p class='sub'>{_html.escape(subtitle)}</p>" if subtitle else "",
    ]
    for i, f in enumerate(figures):
        parts.append(
            f"<div class='fig' id='fig-{i}'><h2>{_html.escape(f.title)}"
            f"</h2><div class='axes'>{_html.escape(f.ylabel)} vs "
            f"{_html.escape(f.xlabel)}"
            + (" (log x)" if f.xlog else "") + "</div></div>")
    parts.append("<script type='application/json' id='viz-data'>"
                 + json.dumps(payload).replace("</", "<\\/")
                 + "</script>")
    parts.append(f"<script>{_JS}</script></body></html>")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(parts))
    return path
