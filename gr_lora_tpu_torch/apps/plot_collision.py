"""Render docs/collision_recovery.json as a grouped-bar SVG.

Twin of gr_lora_tpu/apps/plot_collision.py (pure Python, no device).

    python -m gr_lora_tpu_torch.apps.plot_collision [docs/collision_recovery.json]

Both-packet recovery rate per (offset-kind x amplitude-ratio) cell,
reference-exact trackers vs grace mode — paired horizontal bars, fixed
categorical palette (dataviz reference slots 1/2), values direct-labeled.
"""

from __future__ import annotations

import json
import sys

C_REF = "#2a78d6"      # slot 1: reference-exact trackers (grace 0)
C_GRACE = "#eb6834"    # slot 2: grace mode (grace 8)
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#e4e3df"


def render(artifact: dict) -> str:
    g0 = artifact["grid"]["grace0"]
    g8 = artifact["grid"]["grace8"]
    keys = sorted(g0, key=lambda k: (k.split("_r")[0],
                                     -float(k.split("_r")[1])))
    left, top = 190, 64
    bar_h, pair_gap, group_h = 12, 2, 40
    iw = 560
    width = left + iw + 90
    height = top + len(keys) * group_h + 30

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" viewBox="0 0 {width} {height}" '
           f'font-family="system-ui, sans-serif">'
           f'<rect width="{width}" height="{height}" fill="{SURFACE}"/>'
           f'<text x="12" y="24" fill="{TEXT}" font-size="15" '
           f'font-weight="600">Pyramid collision: both-packet recovery '
           f'across the offset × ratio grid</text>'
           f'<rect x="12" y="38" width="10" height="10" fill="{C_REF}"/>'
           f'<text x="27" y="47" fill="{TEXT}" font-size="12">'
           f'reference-exact trackers</text>'
           f'<rect x="196" y="38" width="10" height="10" fill="{C_GRACE}"/>'
           f'<text x="211" y="47" fill="{TEXT}" font-size="12">'
           f'grace mode (grace=8)</text>']

    # Recessive grid at 0/50/100 %.
    for v, lab in ((0.0, "0%"), (0.5, "50%"), (1.0, "100%")):
        x = left + v * iw
        out.append(f'<line x1="{x:.0f}" y1="{top - 6}" x2="{x:.0f}" '
                   f'y2="{height - 24}" stroke="{GRID}" stroke-width="1"/>')
        out.append(f'<text x="{x:.0f}" y="{height - 8}" fill="{TEXT_2}" '
                   f'font-size="11" text-anchor="middle">{lab}</text>')

    labels = {"phase": "sub-symbol phases", "depth": "overlap depths",
              "aligned": "hop-aligned (degenerate)"}
    for i, k in enumerate(keys):
        kind, ratio = k.split("_r")
        y = top + i * group_h
        out.append(f'<text x="{left - 8}" y="{y + bar_h + 2}" '
                   f'fill="{TEXT}" font-size="12" text-anchor="end">'
                   f'{labels.get(kind, kind)} · ratio {ratio}</text>')
        for j, (src, color) in enumerate(((g0, C_REF), (g8, C_GRACE))):
            v = src[k]
            frac = v["both"] / max(v["trials"], 1)
            by = y + j * (bar_h + pair_gap)
            w = max(frac * iw, 0.5)
            # Thin bar, rounded data end, 2px surface gap via pair_gap.
            out.append(f'<rect x="{left}" y="{by}" width="{w:.1f}" '
                       f'height="{bar_h}" rx="4" fill="{color}"/>')
            out.append(f'<text x="{left + w + 6:.1f}" y="{by + bar_h - 2}" '
                       f'fill="{TEXT}" font-size="11">'
                       f'{v["both"]}/{v["trials"]}</text>')
    out.append("</svg>")
    return "".join(out)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    src = args[0] if args else "docs/collision_recovery.json"
    dst = args[1] if len(args) > 1 else "docs/collision_recovery.svg"
    with open(src) as f:
        artifact = json.load(f)
    with open(dst, "w") as f:
        f.write(render(artifact))
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
