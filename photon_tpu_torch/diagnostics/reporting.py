"""Logical→physical report tree rendered to HTML.

Reference: photon-diagnostics reporting/ — a logical document model
(Document/Chapter/Section with text, tables, plots) walked by physical
renderers (reporting/html/DocumentToHTMLRenderer.scala and text renderers;
plots via xchart PlotUtils). Here plots are dependency-free inline SVG so a
report is one self-contained file.

The port's own copy of photon_tpu/diagnostics/reporting.py (host numpy,
no device code): the same HTML and text for the same ``Document``.
"""
from __future__ import annotations

import dataclasses
import html
from typing import Sequence, Union


@dataclasses.dataclass(frozen=True)
class Text:
    body: str


@dataclasses.dataclass(frozen=True)
class Table:
    headers: list[str]
    rows: list[list[str]]
    caption: str = ""


@dataclasses.dataclass(frozen=True)
class LineChart:
    """One or more series over a shared x axis."""

    title: str
    x_label: str
    y_label: str
    x: list[float]
    series: dict[str, list[float]]  # legend label → y values


@dataclasses.dataclass(frozen=True)
class BarChart:
    title: str
    labels: list[str]
    values: list[float]


Item = Union[Text, Table, LineChart, BarChart]


@dataclasses.dataclass(frozen=True)
class Section:
    title: str
    items: list[Item]


@dataclasses.dataclass(frozen=True)
class Chapter:
    title: str
    sections: list[Section]


@dataclasses.dataclass(frozen=True)
class Document:
    title: str
    chapters: list[Chapter]


_W, _H, _PAD = 560, 300, 44
_COLORS = ["#4878d0", "#ee854a", "#6acc64", "#d65f5f", "#956cb4", "#8c613c"]


def _scale(vals: Sequence[float]) -> tuple[float, float]:
    lo, hi = min(vals), max(vals)
    if hi == lo:
        hi = lo + 1.0
    return lo, hi


def _svg_open(title: str) -> list[str]:
    return [
        f'<svg viewBox="0 0 {_W} {_H}" width="{_W}" height="{_H}" '
        'xmlns="http://www.w3.org/2000/svg" style="background:#fff">',
        f'<text x="{_W / 2}" y="18" text-anchor="middle" '
        f'font-size="14" font-weight="bold">{html.escape(title)}</text>',
        f'<rect x="{_PAD}" y="28" width="{_W - 2 * _PAD}" '
        f'height="{_H - 28 - _PAD}" fill="none" stroke="#999"/>',
    ]


def render_line_chart(chart: LineChart) -> str:
    if not chart.x:
        return "<p>(empty chart)</p>"
    xlo, xhi = _scale(chart.x)
    all_y = [v for ys in chart.series.values() for v in ys]
    ylo, yhi = _scale(all_y or [0.0])
    plot_w, plot_h = _W - 2 * _PAD, _H - 28 - _PAD

    def px(x: float) -> float:
        return _PAD + (x - xlo) / (xhi - xlo) * plot_w

    def py(y: float) -> float:
        return 28 + plot_h - (y - ylo) / (yhi - ylo) * plot_h

    out = _svg_open(chart.title)
    for i, (label, ys) in enumerate(chart.series.items()):
        color = _COLORS[i % len(_COLORS)]
        pts = " ".join(
            f"{px(x):.1f},{py(y):.1f}" for x, y in zip(chart.x, ys)
        )
        out.append(
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            'stroke-width="2"/>'
        )
        for x, y in zip(chart.x, ys):
            out.append(
                f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" r="3" '
                f'fill="{color}"/>'
            )
        out.append(
            f'<text x="{_W - _PAD + 4}" y="{40 + 16 * i}" font-size="11" '
            f'fill="{color}">{html.escape(label)}</text>'
        )
    out.append(
        f'<text x="{_W / 2}" y="{_H - 6}" text-anchor="middle" '
        f'font-size="12">{html.escape(chart.x_label)}</text>'
    )
    out.append(
        f'<text x="12" y="{_H / 2}" text-anchor="middle" font-size="12" '
        f'transform="rotate(-90 12 {_H / 2})">'
        f"{html.escape(chart.y_label)}</text>"
    )
    for frac in (0.0, 0.5, 1.0):
        out.append(
            f'<text x="{_PAD - 4}" y="{py(ylo + frac * (yhi - ylo)):.1f}" '
            'text-anchor="end" font-size="10">'
            f"{ylo + frac * (yhi - ylo):.4g}</text>"
        )
        out.append(
            f'<text x="{px(xlo + frac * (xhi - xlo)):.1f}" y="{_H - _PAD + 14}" '
            'text-anchor="middle" font-size="10">'
            f"{xlo + frac * (xhi - xlo):.4g}</text>"
        )
    out.append("</svg>")
    return "\n".join(out)


def render_bar_chart(chart: BarChart) -> str:
    if not chart.values:
        return "<p>(empty chart)</p>"
    lo = min(0.0, min(chart.values))
    hi = max(0.0, max(chart.values))
    if hi == lo:
        hi = lo + 1.0
    plot_w, plot_h = _W - 2 * _PAD, _H - 28 - _PAD
    n = len(chart.values)
    bar_w = plot_w / n * 0.8

    def py(y: float) -> float:
        return 28 + plot_h - (y - lo) / (hi - lo) * plot_h

    out = _svg_open(chart.title)
    for i, (label, v) in enumerate(zip(chart.labels, chart.values)):
        x = _PAD + plot_w * (i + 0.1) / n
        y0, y1 = py(max(v, 0.0)), py(min(v, 0.0))
        out.append(
            f'<rect x="{x:.1f}" y="{y0:.1f}" width="{bar_w:.1f}" '
            f'height="{max(y1 - y0, 0.5):.1f}" fill="{_COLORS[0]}"/>'
        )
        out.append(
            f'<text x="{x + bar_w / 2:.1f}" y="{_H - _PAD + 14}" '
            f'text-anchor="middle" font-size="9">'
            f"{html.escape(str(label)[:10])}</text>"
        )
    out.append(
        f'<text x="{_PAD - 4}" y="{py(hi):.1f}" text-anchor="end" '
        f'font-size="10">{hi:.4g}</text>'
    )
    out.append(
        f'<text x="{_PAD - 4}" y="{py(lo):.1f}" text-anchor="end" '
        f'font-size="10">{lo:.4g}</text>'
    )
    out.append("</svg>")
    return "\n".join(out)


def _render_item(item: Item) -> str:
    if isinstance(item, Text):
        return f"<p>{html.escape(item.body)}</p>"
    if isinstance(item, Table):
        head = "".join(f"<th>{html.escape(h)}</th>" for h in item.headers)
        body = "".join(
            "<tr>"
            + "".join(f"<td>{html.escape(str(c))}</td>" for c in row)
            + "</tr>"
            for row in item.rows
        )
        cap = (
            f"<caption>{html.escape(item.caption)}</caption>"
            if item.caption
            else ""
        )
        return (
            f"<table>{cap}<thead><tr>{head}</tr></thead>"
            f"<tbody>{body}</tbody></table>"
        )
    if isinstance(item, LineChart):
        return render_line_chart(item)
    if isinstance(item, BarChart):
        return render_bar_chart(item)
    raise TypeError(f"unknown report item {type(item)}")


_CSS = """
body{font-family:system-ui,sans-serif;max-width:900px;margin:2em auto;
     color:#1a1a2e;padding:0 1em}
h1{border-bottom:2px solid #4878d0}h2{border-bottom:1px solid #ccc}
table{border-collapse:collapse;margin:1em 0}
th,td{border:1px solid #bbb;padding:4px 10px;font-size:13px;text-align:right}
th{background:#eef}caption{font-style:italic;padding:4px}
"""


def render_html(doc: Document) -> str:
    """Numbered chapters/sections with anchors and a table of contents
    (reference html/DocumentToHTMLRenderer.scala numbers the logical tree
    and emits navigation)."""
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{html.escape(doc.title)}</title>",
        f"<style>{_CSS}</style></head><body>",
        f"<h1>{html.escape(doc.title)}</h1>",
    ]
    toc = ["<nav><strong>Contents</strong><ul>"]
    for ci, chapter in enumerate(doc.chapters, 1):
        toc.append(
            f'<li><a href="#ch{ci}">{ci}. '
            f"{html.escape(chapter.title)}</a><ul>"
        )
        for si, section in enumerate(chapter.sections, 1):
            toc.append(
                f'<li><a href="#ch{ci}s{si}">{ci}.{si} '
                f"{html.escape(section.title)}</a></li>"
            )
        toc.append("</ul></li>")
    toc.append("</ul></nav>")
    parts.extend(toc)
    for ci, chapter in enumerate(doc.chapters, 1):
        parts.append(
            f'<h2 id="ch{ci}">{ci}. {html.escape(chapter.title)}</h2>'
        )
        for si, section in enumerate(chapter.sections, 1):
            parts.append(
                f'<h3 id="ch{ci}s{si}">{ci}.{si} '
                f"{html.escape(section.title)}</h3>"
            )
            parts.extend(_render_item(i) for i in section.items)
    parts.append("</body></html>")
    return "\n".join(parts)


def render_text(doc: Document) -> str:
    """Plain-text physical renderer (reference reporting/text/)."""
    lines = [doc.title, "=" * len(doc.title)]
    for chapter in doc.chapters:
        lines += ["", chapter.title, "-" * len(chapter.title)]
        for section in chapter.sections:
            lines += ["", f"## {section.title}"]
            for item in section.items:
                if isinstance(item, Text):
                    lines.append(item.body)
                elif isinstance(item, Table):
                    lines.append(" | ".join(item.headers))
                    lines += [
                        " | ".join(str(c) for c in row) for row in item.rows
                    ]
                elif isinstance(item, (LineChart, BarChart)):
                    lines.append(f"[chart: {item.title}]")
    return "\n".join(lines) + "\n"
