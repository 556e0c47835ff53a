"""Compare K1's peak lists (the rDFT peak lattice at SF8) of the JAX
package, at both of its mirror-lane reversals, and of the port, on the
CPU.

    JAX_PLATFORMS=cpu python3 k1_rev_reference.py [PDU ...]

Makes chip_smoke.py phase 10's capture on the CPU (wideband_reference.py
does the same), channelizes its first block with the JAX package's
channelizer, and for each given weak pair packet (the two that the JAX
package's ``fused`` gateway misses and the port's decodes, unless given)
cuts 640 hops of its channel from four symbols before its strong
partner.  The same samples go through the JAX ``make_rdft_peaks`` at
``rev="matmul"`` (its default: the mirror lanes reversed by a bf16
anti-identity product) and ``rev="flip"`` (Pallas in interpret mode) and
through the port's ``fused`` lattice (its plain version).  Prints, for
each packet, the hops whose peak bins differ between each two of the
three, and the largest height difference of matmul against flip and of
the port against flip where the bins agree.  Needs the JAX package; runs
on the CPU only.
"""

from __future__ import annotations

import argparse

import numpy as np

HOPS = 640
WEAK = ("0630f0f79af7898b543b7001", "0630f0102d7a61f0ebceb401")


def main(argv=None) -> int:
    import jax
    import torch

    import chip_smoke as cs
    from gr_lora_tpu import LoraConfig as JaxConfig
    from gr_lora_tpu.ops.pallas_rdft import make_rdft_peaks
    from gr_lora_tpu.pipeline.channelizer import channelize
    from gr_lora_tpu_torch.models.pyramid import peak_lattice_fn

    ap = argparse.ArgumentParser()
    ap.add_argument("pdus", nargs="*", default=list(WEAK))
    args = ap.parse_args(argv)
    wide, injected = cs.wideband_capture(torch.device("cpu"))
    block = np.ascontiguousarray(wide[:cs.WB_BLOCK]).view(np.float32) \
        .reshape(-1, 2)
    del wide
    x = np.asarray(channelize(block, cs.CHANNELS, cs.WB_FS))
    base = cs.base_config()
    jcfg = JaxConfig(**{f: getattr(base, f) for f in (
        "sf", "cr", "crc", "ldr", "explicit_header", "payload_len", "p",
        "fft_factor", "threshold")})
    n = base.num_samples
    hop = n // 8
    lattices = {rev: make_rdft_peaks(jcfg, HOPS, 8, rev=rev, interpret=True)
                for rev in ("matmul", "flip")}
    port = peak_lattice_fn(base, HOPS, 8, "fused")
    for pdu in args.pdus:
        weak = next(q for q in injected if q.pdu == pdu)
        strong = next(q for q in injected if q.channel == weak.channel
                      and q.kind == "strong")
        lo = max(strong.offset - 4 * n, 0)
        seg = np.array(x[weak.channel, lo:lo + HOPS * hop + n - hop])
        outs = {rev: [np.asarray(a) for a in jax.device_get(f(seg))]
                for rev, f in lattices.items()}
        with torch.no_grad():
            outs["port"] = [a.numpy() for a in port(torch.from_numpy(seg))]
        rows = {k: [tuple(sorted(b[t][v[t]].tolist())) for t in range(HOPS)]
                for k, (b, _, _, v) in outs.items()}

        def differ(a, b):
            return sum(ra != rb for ra, rb in zip(rows[a], rows[b]))

        fb, fh, _, fv = outs["flip"]
        pb, ph, _, pv = outs["port"]
        same = fv & pv & (fb == pb)
        print(f"{pdu} channel {weak.channel}, {HOPS} hops: hops whose peak "
              f"bins differ: matmul vs flip {differ('matmul', 'flip')}, "
              f"port vs flip {differ('port', 'flip')}, port vs matmul "
              f"{differ('port', 'matmul')}; max |h| matmul - flip "
              f"{np.abs(outs['matmul'][1] - fh).max():.4g}, port - flip "
              f"(same bins) {np.abs(ph - fh)[same].max():.4g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
