"""Render docs/per_curves.json as a small-multiples SVG.

Twin of gr_lora_tpu/apps/plot_per.py (pure Python, no device).

    python -m gr_lora_tpu_torch.apps.plot_per [docs/per_curves.json]

One panel per spreading factor, two series per panel (plain FSM vs weak
demod) — identity is carried by both color (fixed categorical slots) and
marker shape, with direct labels, so it is never color-alone.  Colors are
the dataviz reference palette's validated slots 1/2; single y-scale per
panel (PER, linear 0..1), recessive grid.
"""

from __future__ import annotations

import json
import sys

# Fixed categorical assignment (dataviz reference palette, light mode).
C_PLAIN = "#2a78d6"     # slot 1 (blue)  — plain FSM
C_WEAK = "#eb6834"      # slot 2 (orange) — weak demod
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#e4e3df"


def render(artifact: dict) -> str:
    curves = artifact["curves"]
    sfs = sorted({int(k.split("_")[0][2:]) for k in curves})
    cols, rows = 3, -(-len(sfs) // 3)
    pw, ph, mx, my, top = 300, 210, 52, 44, 56
    width = cols * pw + 20
    height = top + rows * ph + 16

    def panel(idx, sf):
        px = 10 + (idx % cols) * pw + mx
        py = top + (idx // cols) * ph
        iw, ih = pw - mx - 16, ph - my
        series = []
        for kind, color, marker in (("plain", C_PLAIN, "circle"),
                                    ("weak", C_WEAK, "rect")):
            c = curves.get(f"sf{sf}_{kind}")
            if c:
                series.append((kind, color, marker, c))
        if not series:
            return ""
        xs_all = [s for _, _, _, c in series for s in c["snr_db"]]
        x0, x1 = min(xs_all), max(xs_all)

        def X(v):
            return px + (v - x0) / max(x1 - x0, 1e-9) * iw

        def Y(v):
            return py + 18 + (1.0 - v) * (ih - 18)

        out = []
        # Recessive grid: PER 0 / 0.5 / 1 plus the waterfall guide.
        for gv, lab in ((0.0, "0"), (0.5, "0.5"), (1.0, "1")):
            y = Y(gv)
            out.append(f'<line x1="{px}" y1="{y:.1f}" x2="{px + iw}" '
                       f'y2="{y:.1f}" stroke="{GRID}" stroke-width="1"/>')
            out.append(f'<text x="{px - 6}" y="{y + 4:.1f}" fill="{TEXT_2}" '
                       f'font-size="11" text-anchor="end">{lab}</text>')
        # X ticks: ends + zero if inside.
        for tv in sorted({x0, x1} | ({0.0} if x0 < 0 < x1 else set())):
            out.append(f'<text x="{X(tv):.1f}" y="{py + ih + 16:.1f}" '
                       f'fill="{TEXT_2}" font-size="11" '
                       f'text-anchor="middle">{tv:g}</text>')
        out.append(f'<text x="{px + iw / 2}" y="{py + ih + 32:.1f}" '
                   f'fill="{TEXT_2}" font-size="11" text-anchor="middle">'
                   f'in-band SNR (dB)</text>')
        out.append(f'<text x="{px}" y="{py + 6}" fill="{TEXT}" '
                   f'font-size="13" font-weight="600">SF{sf}</text>')
        for kind, color, marker, c in series:
            pts = sorted(zip(c["snr_db"], c["per"]))
            path = " ".join(f'{"M" if i == 0 else "L"}{X(x):.1f},{Y(y):.1f}'
                            for i, (x, y) in enumerate(pts))
            out.append(f'<path d="{path}" fill="none" stroke="{color}" '
                       f'stroke-width="2"/>')
            for x, y in pts:
                if marker == "circle":
                    out.append(f'<circle cx="{X(x):.1f}" cy="{Y(y):.1f}" '
                               f'r="4" fill="{color}" stroke="{SURFACE}" '
                               f'stroke-width="2"/>')
                else:
                    out.append(f'<rect x="{X(x) - 4:.1f}" '
                               f'y="{Y(y) - 4:.1f}" width="8" height="8" '
                               f'fill="{color}" stroke="{SURFACE}" '
                               f'stroke-width="2"/>')
            wf = c.get("waterfall_db")
            if wf is not None:
                out.append(f'<line x1="{X(wf):.1f}" y1="{Y(1):.1f}" '
                           f'x2="{X(wf):.1f}" y2="{Y(0):.1f}" '
                           f'stroke="{color}" stroke-width="1" '
                           f'stroke-dasharray="3,3" opacity="0.6"/>')
        # Direct labels at the last point of each series.
        for kind, color, marker, c in series:
            pts = sorted(zip(c["snr_db"], c["per"]))
            lx, ly = pts[-1]
            out.append(f'<text x="{X(lx) - 4:.1f}" y="{Y(ly) - 8:.1f}" '
                       f'fill="{TEXT}" font-size="11" '
                       f'text-anchor="end">{kind}</text>')
        return "".join(out)

    dev = artifact.get("device", "?")
    trials = next(iter(curves.values()))["trials"] if curves else 0
    legend = (
        f'<circle cx="16" cy="40" r="4" fill="{C_PLAIN}"/>'
        f'<text x="26" y="44" fill="{TEXT}" font-size="12">plain FSM</text>'
        f'<rect x="102" y="36" width="8" height="8" fill="{C_WEAK}"/>'
        f'<text x="116" y="44" fill="{TEXT}" font-size="12">weak demod '
        f'(two-copy combining)</text>'
        f'<text x="{width - 12}" y="44" fill="{TEXT_2}" font-size="11" '
        f'text-anchor="end">dashed = PER 0.5 waterfall · {trials} '
        f'trials/point · {dev}</text>')
    body = "".join(panel(i, sf) for i, sf in enumerate(sfs))
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}" '
        f'font-family="system-ui, sans-serif">'
        f'<rect width="{width}" height="{height}" fill="{SURFACE}"/>'
        f'<text x="12" y="22" fill="{TEXT}" font-size="15" '
        f'font-weight="600">LoRa packet error rate vs in-band SNR</text>'
        f'{legend}{body}</svg>')


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    src = args[0] if args else "docs/per_curves.json"
    dst = args[1] if len(args) > 1 else "docs/per_curves.svg"
    with open(src) as f:
        artifact = json.load(f)
    svg = render(artifact)
    with open(dst, "w") as f:
        f.write(svg)
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
