"""Figures drawn with cv2, in place of the JAX package's matplotlib (which
the card's machine does not have): a white canvas of rows x columns of
panels at matplotlib's size (inches x dpi), and per panel the axes with
ticks and a title, line series with a legend, bars, histograms, box plots,
labelled scatters, images and a text box.

Each figure keeps its JAX counterpart's file name, layout and content;
pixels are not meant to match matplotlib's. cv2's Hershey fonts draw ASCII
only, so text goes through :func:`ascii_text` (``μ`` -> ``mu``, ``→`` ->
``->``, ...).
"""

from __future__ import annotations

import math
from pathlib import Path

import cv2
import numpy as np

# matplotlib's tab10 cycle, BGR
TAB10 = ((180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
         (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23))
NAMED = {"red": (0, 0, 255), "green": (0, 128, 0), "blue": (255, 0, 0),
         "orange": (0, 165, 255), "gray": (128, 128, 128), "black": (0, 0, 0),
         "lightblue": (230, 216, 173)}
BLACK, GRID = (0, 0, 0), (225, 225, 225)
FONT = cv2.FONT_HERSHEY_SIMPLEX
_ASCII = {"μ": "mu", "σ": "sigma", "→": "->", "–": "-", "—": "-", "×": "x", "²": "^2"}


def ascii_text(s: str) -> str:
    for k, v in _ASCII.items():
        s = s.replace(k, v)
    return s.encode("ascii", "replace").decode()


def color(c) -> tuple:
    """A BGR tuple from a name, a tab10 index or a BGR tuple."""
    if isinstance(c, str):
        return NAMED[c]
    if isinstance(c, int):
        return TAB10[c % len(TAB10)]
    return tuple(int(v) for v in c)


def put_text(img: np.ndarray, text: str, org: tuple, scale: float = 0.45, col=BLACK,
             anchor: str = "left") -> None:
    """One line of text at ``org`` (its baseline); anchor left, center or right."""
    text = ascii_text(text)
    (w, _), _ = cv2.getTextSize(text, FONT, scale, 1)
    x = org[0] - (w // 2 if anchor == "center" else w if anchor == "right" else 0)
    cv2.putText(img, text, (int(x), int(org[1])), FONT, scale, color(col), 1, cv2.LINE_AA)


def _fmt(v: float) -> str:
    return f"{v:.3g}"


def _limits(lo: float, hi: float, pad: float = 0.05) -> tuple[float, float]:
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return 0.0, 1.0
    if hi <= lo:
        return lo - 0.5, hi + 0.5
    d = (hi - lo) * pad
    return lo - d, hi + d


class Panel:
    """One subplot: a pixel rectangle of its figure's canvas. Call
    :meth:`axes` (or :meth:`image`) first; the drawing methods map data
    through the limits it sets."""

    def __init__(self, fig: "Figure", x0: int, y0: int, x1: int, y1: int):
        self.fig, self.box = fig, (x0, y0, x1, y1)
        self.xlim = self.ylim = (0.0, 1.0)
        self.plot = (x0, y0, x1, y1)
        self.series: list[tuple[str, tuple]] = []

    @property
    def img(self) -> np.ndarray:
        return self.fig.img

    def axes(self, xlim, ylim, title: str = "", xlabel: str = "", ylabel: str = "",
             grid: bool = False, xticks: bool = True, title_color=BLACK) -> "Panel":
        """A frame with 5 ticks an axis (numbers) and the labels."""
        x0, y0, x1, y1 = self.box
        self.plot = (x0 + 58, y0 + 24, x1 - 10, y1 - (38 if xlabel else 24))
        self.xlim, self.ylim = tuple(map(float, xlim)), tuple(map(float, ylim))
        px0, py0, px1, py1 = self.plot
        for k in range(5):
            fx = self.xlim[0] + (self.xlim[1] - self.xlim[0]) * k / 4
            fy = self.ylim[0] + (self.ylim[1] - self.ylim[0]) * k / 4
            X, Y = self.px(fx, fy)
            if grid:
                cv2.line(self.img, (X, py0), (X, py1), GRID, 1)
                cv2.line(self.img, (px0, Y), (px1, Y), GRID, 1)
            if xticks:
                cv2.line(self.img, (X, py1), (X, py1 + 4), BLACK, 1)
                put_text(self.img, _fmt(fx), (X, py1 + 16), 0.35, anchor="center")
            cv2.line(self.img, (px0 - 4, Y), (px0, Y), BLACK, 1)
            put_text(self.img, _fmt(fy), (px0 - 6, Y + 4), 0.35, anchor="right")
        cv2.rectangle(self.img, (px0, py0), (px1, py1), BLACK, 1)
        put_text(self.img, title, ((px0 + px1) // 2, y0 + 16), 0.5, title_color, "center")
        if xlabel:
            put_text(self.img, xlabel, ((px0 + px1) // 2, y1 - 6), 0.4, anchor="center")
        if ylabel:
            put_text(self.img, ylabel, (x0 + 2, py0 - 6), 0.35)
        return self

    def px(self, x: float, y: float) -> tuple[int, int]:
        (a, b), (c, d) = self.xlim, self.ylim
        px0, py0, px1, py1 = self.plot
        fx = (x - a) / (b - a) if b > a else 0.5
        fy = (y - c) / (d - c) if d > c else 0.5
        fx, fy = min(max(fx, -0.02), 1.02), min(max(fy, -0.02), 1.02)
        return int(round(px0 + fx * (px1 - px0))), int(round(py1 - fy * (py1 - py0)))

    def line(self, xs, ys, col=0, label: str | None = None, dashed: bool = False,
             width: int = 2) -> None:
        """A polyline through the finite points (a NaN breaks it)."""
        col = color(col)
        pts = [self.px(x, y) if np.isfinite(x) and np.isfinite(y) else None
               for x, y in zip(xs, ys)]
        for i, (a, b) in enumerate(zip(pts[:-1], pts[1:])):
            if a is not None and b is not None and not (dashed and i % 2):
                cv2.line(self.img, a, b, col, width, cv2.LINE_AA)
        if len(pts) == 1 and pts[0] is not None:
            cv2.circle(self.img, pts[0], 3, col, -1, cv2.LINE_AA)
        if label:
            self.series.append((label, col))

    def vline(self, x: float, col="gray", dashed: bool = True) -> None:
        X, top = self.px(x, self.ylim[1])
        _, bottom = self.px(x, self.ylim[0])
        step = 8 if dashed else bottom - top
        for y in range(top, bottom, step):
            cv2.line(self.img, (X, y), (X, min(y + (4 if dashed else step), bottom)),
                     color(col), 1)

    def bars(self, heights, labels, col=0) -> None:
        """One bar a category at x = 0, 1, ...; the labels under them."""
        _, _, _, py1 = self.plot
        for i, (h, name) in enumerate(zip(heights, labels)):
            a, top = self.px(i - 0.4, h)
            b, base = self.px(i + 0.4, 0.0)
            cv2.rectangle(self.img, (a, top), (b, base), color(col), -1)
            put_text(self.img, str(name)[:28], ((a + b) // 2, py1 + 16 + 12 * (i % 2)), 0.33,
                     anchor="center")

    def hist(self, edges, counts, col=0, alpha: float = 0.7) -> None:
        """Histogram bars over ``edges``, blended at ``alpha`` with an outline."""
        layer = self.img.copy()
        for lo, hi, h in zip(edges[:-1], edges[1:], counts):
            if h > 0:
                cv2.rectangle(layer, self.px(lo, h), self.px(hi, self.ylim[0]), color(col), -1)
                cv2.rectangle(layer, self.px(lo, h), self.px(hi, self.ylim[0]), BLACK, 1)
        x0, y0, x1, y1 = self.plot
        roi = np.s_[y0:y1 + 1, x0:x1 + 1]
        self.img[roi] = cv2.addWeighted(layer[roi], alpha, self.img[roi], 1 - alpha, 0)

    def boxplot(self, groups, labels) -> None:
        """Median, quartiles and 1.5 IQR whiskers of each group at x = 1, 2, ...;
        points beyond the whiskers as circles."""
        _, _, _, py1 = self.plot
        for i, (vals, name) in enumerate(zip(groups, labels), start=1):
            v = np.asarray(vals, np.float64)
            v = v[np.isfinite(v)]
            cx, _ = self.px(i, 0.0)
            put_text(self.img, str(name)[:22], (cx, py1 + 16 + 12 * (i % 2)), 0.33,
                     anchor="center")
            if not v.size:
                continue
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            iqr = q3 - q1
            lo = v[v >= q1 - 1.5 * iqr].min()
            hi = v[v <= q3 + 1.5 * iqr].max()
            a, top = self.px(i - 0.25, q3)
            b, bottom = self.px(i + 0.25, q1)
            cv2.rectangle(self.img, (a, top), (b, bottom), BLACK, 1)
            _, m = self.px(i, med)
            cv2.line(self.img, (a, m), (b, m), NAMED["orange"], 2)
            for end, edge in ((hi, top), (lo, bottom)):
                _, e = self.px(i, end)
                cv2.line(self.img, (cx, edge), (cx, e), BLACK, 1)
                cv2.line(self.img, (cx - 8, e), (cx + 8, e), BLACK, 1)
            for o in v[(v < lo) | (v > hi)]:
                cv2.circle(self.img, self.px(i, o), 3, BLACK, 1, cv2.LINE_AA)

    def scatter(self, xs, ys, codes, labels=None) -> None:
        """Filled points coloured by integer category code, each with its label."""
        for k, (x, y, c) in enumerate(zip(xs, ys, codes)):
            if not (np.isfinite(x) and np.isfinite(y)):
                continue
            p = self.px(x, y)
            cv2.circle(self.img, p, 6, color(int(c)), -1, cv2.LINE_AA)
            if labels is not None:
                put_text(self.img, str(labels[k]), (p[0] + 6, p[1] - 6), 0.33)

    def legend(self) -> None:
        _, py0, px1, _ = self.plot
        for i, (name, col) in enumerate(self.series):
            y = py0 + 14 + 14 * i
            cv2.line(self.img, (px1 - 60, y - 4), (px1 - 44, y - 4), col, 2)
            put_text(self.img, name, (px1 - 40, y), 0.35)

    def image(self, img: np.ndarray, title: str = "", title_color=BLACK,
              vmin: float | None = None, vmax: float | None = None) -> None:
        """An RGB (H, W, 3) uint8 image, or a gray (H, W) one mapped from
        [vmin, vmax] (its own range by default), fitted into the panel under
        its title; no axes."""
        x0, y0, x1, y1 = self.box
        lines = title.split("\n") if title else []
        top = y0 + 4 + 16 * len(lines)
        for k, line in enumerate(lines):
            put_text(self.img, line, ((x0 + x1) // 2, y0 + 16 + 16 * k), 0.45, title_color,
                     "center")
        a = np.asarray(img)
        if a.ndim == 2:
            a = a.astype(np.float64)
            lo = float(np.nanmin(a)) if vmin is None else vmin
            hi = float(np.nanmax(a)) if vmax is None else vmax
            a = np.clip((a - lo) / (hi - lo), 0, 1) * 255 if hi > lo else np.zeros_like(a)
            a = np.repeat(a.astype(np.uint8)[..., None], 3, axis=-1)
        else:
            a = cv2.cvtColor(np.clip(a, 0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
        bw, bh = x1 - x0 - 4, y1 - top - 2
        if bw < 2 or bh < 2:
            return
        s = min(bw / a.shape[1], bh / a.shape[0])
        w, h = max(1, int(a.shape[1] * s)), max(1, int(a.shape[0] * s))
        ox, oy = x0 + 2 + (bw - w) // 2, top + (bh - h) // 2
        self.img[oy:oy + h, ox:ox + w] = cv2.resize(a, (w, h), interpolation=cv2.INTER_AREA)

    def text_box(self, lines, at: tuple[float, float] = (0.05, 0.95), scale: float = 0.35,
                 fill=(255, 255, 255)) -> None:
        """Lines in a filled box whose top-left corner is at a fraction of the
        plot area."""
        px0, py0, px1, py1 = self.plot
        x, y = int(px0 + at[0] * (px1 - px0)), int(py1 - at[1] * (py1 - py0))
        text = [ascii_text(s) for s in lines]
        w = max(cv2.getTextSize(s, FONT, scale, 1)[0][0] for s in text) + 8
        cv2.rectangle(self.img, (x, y), (x + w, y + 14 * len(text) + 6), fill, -1)
        cv2.rectangle(self.img, (x, y), (x + w, y + 14 * len(text) + 6), GRID, 1)
        for k, s in enumerate(text):
            put_text(self.img, s, (x + 4, y + 14 * (k + 1)), scale)


class Figure:
    """A white ``width_in`` x ``height_in`` inch canvas at ``dpi`` (as
    matplotlib's ``figsize`` and ``dpi``), ``rows`` x ``cols`` panels under
    an optional title band and over an optional footer band (pixels)."""

    def __init__(self, width_in: float, height_in: float, dpi: int, rows: int, cols: int,
                 title: str = "", footer: int = 0):
        self.img = np.full((int(round(height_in * dpi)), int(round(width_in * dpi)), 3), 255,
                           np.uint8)
        h, w = self.img.shape[:2]
        self.rows, self.cols = rows, cols
        self.top = 36 if title else 4
        self.bottom = h - footer
        if title:
            put_text(self.img, title, (w // 2, 24), 0.7, anchor="center")

    def panel(self, r: int, c: int) -> Panel:
        w = self.img.shape[1]
        ph = (self.bottom - self.top) / self.rows
        pw = w / self.cols
        return Panel(self, int(c * pw) + 4, int(self.top + r * ph) + 4,
                     int((c + 1) * pw) - 4, int(self.top + (r + 1) * ph) - 4)

    def footer(self, text: str, fill=(224, 255, 255)) -> None:
        h, w = self.img.shape[:2]
        cv2.rectangle(self.img, (8, self.bottom + 4), (w - 8, h - 4), fill, -1)
        put_text(self.img, text, (16, (self.bottom + h) // 2 + 5), 0.5)

    def save(self, path: str | Path) -> Path:
        cv2.imwrite(str(path), self.img)
        return Path(path)


def hist_counts(values, bins: int, density: bool = False):
    """(edges, heights) of ``bins`` equal bins over the values' range, as
    ``plt.hist`` draws them; densities integrate to 1."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    counts, edges = np.histogram(v, bins=bins)
    if density and counts.sum():
        counts = counts / counts.sum() / np.diff(edges)
    return edges, counts


def hist_panel(p: Panel, values, bins: int, col=0, density: bool = False, **axes) -> Panel:
    """A histogram of ``values`` in its own axes."""
    edges, counts = hist_counts(values, bins, density)
    top = float(np.max(counts)) if len(counts) else 1.0
    p.axes((edges[0], edges[-1]) if len(edges) else (0, 1), (0.0, (top or 1.0) * 1.05), **axes)
    p.hist(edges, counts, col)
    return p


def limits(*arrays, pad: float = 0.05) -> tuple[float, float]:
    """Data limits over every finite value of the arrays, padded."""
    v = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays] or [np.zeros(0)])
    v = v[np.isfinite(v)]
    return _limits(float(v.min()), float(v.max()), pad) if v.size else (0.0, 1.0)
