"""Time the lattice kernels, P1 and P2 of two trees of the repo in turns,
on one NVIDIA GPU.

    python3 chip_compare.py PARENT_TREE [CHANGE_TREE]

Runs ``python3 chip_compare.py --one TREE`` for PARENT, CHANGE, CHANGE,
PARENT (CHANGE defaults to this checkout), each in its own process with
TREE first on ``sys.path``, so that each builds and times its own
kernels on the same card.  It calls only the modules' stable entry
points, so a parent whose chip_smoke.py lacks a phase is still timed.
One run times, with CUDA events after one warm-up launch (10 launches
each): K1 (rDFT peaks) at SF7, SF8 and SF9 and K2 (overlap peaks, from
its chunk spectra) at SF10 and SF12 on chip_smoke.py's north-star event
windows (8 lanes), each whole and as the unfused pair (its dense front
end, K3's or K5's kernel, and peak_topm on what that wrote); then, on
chip_smoke.py's always-on block (16 channels x 2048 hops at SF8 x ff
8), K5 on the block's chunk spectra (first, before the others
allocate), K3, K4b and K6; then P1 at the main dot shape, and P2's three
kinds (``mxu``, ``vpu``, ``both``, 64 steps x 2 rounds) at the same
shape.  Prints each run's JSON line, then the parent's and the change's
times side by side with the card's name and power limit.  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ITERS = 10


def _smoke():
    """This checkout's chip_smoke.py (its fixtures and timer), whichever
    tree is first on sys.path."""
    spec = importlib.util.spec_from_file_location("smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    smoke = _smoke()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is false: a CUDA device is "
                   "needed")
    from gr_lora_tpu_torch.dist.collision_gateway import \
        TriggeredPyramidGateway
    from gr_lora_tpu_torch.ops.chunk_spectra import ChunkSpectra
    from gr_lora_tpu_torch.ops.direct import DirectSpectra
    from gr_lora_tpu_torch.ops.overlap_spectra import OverlapSpectra
    from gr_lora_tpu_torch.ops.peak_epilogue import launch_topm
    from gr_lora_tpu_torch.ops.probes import (MAIN_SHAPE, OverlapProbe,
                                              RateProbe, probe_inputs)
    from gr_lora_tpu_torch.ops.rdft_spectra import RdftSpectra

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda:0")
    ms = {}
    with torch.no_grad():
        gw = TriggeredPyramidGateway(smoke.base_config(), smoke.CHANNELS,
                                     sfs=smoke.SFS, max_payload_len=16,
                                     backend="fused", tracker="host",
                                     device=dev)
        iq, singles = smoke.north_star_fixture(
            {sf: st.cfg for sf, st in gw.sf_states.items()})
        iq_dev = torch.from_numpy(iq).to(dev)
        for sf in (7, 8, 9):
            st = gw.sf_states[sf]
            mod = gw.lattice(sf)
            x = smoke._event_windows(iq_dev, gw, singles, sf,
                                     gw.event_batch, gw._win_samples(st))
            tag = f"SF{sf} [{x.shape[0]}, {mod.num_frames}]"
            ms[f"K1 {tag}"] = smoke._time_ms(lambda: mod(x), ITERS)
            # The unfused pair: K3's kernel and the top-M on its folds.
            sp = mod.front.kernel(x)
            ms[f"K1 front {tag}"] = smoke._time_ms(
                lambda: mod.front.kernel(x), ITERS)
            ms[f"K1 top-M {tag}"] = smoke._time_ms(
                lambda: launch_topm(*sp, mod.threshold, mod.max_peaks),
                ITERS)
            del sp
        for sf in (10, 12):
            lat = gw.lattice(sf)
            mod = lat.inner
            x = smoke._event_windows(iq_dev, gw, singles, sf,
                                     gw.event_batch, lat.seg)
            g = mod.plan.chunk_dft(x, mod.num_hops)
            tag = f"SF{sf} [{x.shape[0]}, {mod.num_hops}]"
            ms[f"K2 {tag}"] = smoke._time_ms(lambda: mod.from_chunks(g),
                                             ITERS)
            # The unfused pair: its front end (K5's kernel) and the top-M
            # on what that wrote.
            sp = mod.front.kernel(g)
            ms[f"K2 front {tag}"] = smoke._time_ms(
                lambda: mod.front.kernel(g), ITERS)
            ms[f"K2 top-M {tag}"] = smoke._time_ms(
                lambda: launch_topm(*sp, mod.threshold, mod.max_peaks),
                ITERS)
            del g, sp
        del gw, iq, iq_dev
        torch.cuda.empty_cache()

        cfg = smoke.base_config()
        ao, _ = smoke.always_on_fixture(cfg)
        n = cfg.num_samples
        block = smoke.AO_BLOCK_HOPS * n // 8 + n - n // 8
        x8 = torch.from_numpy(ao[:, :block]).to(dev)
        hops = smoke.AO_BLOCK_HOPS
        # K5 first: its time must not depend on what the others allocated.
        mod = OverlapSpectra(cfg, hops).to(dev)
        g = mod.plan.chunk_dft(x8, hops)
        ms[f"K5 SF8 ff8 G {list(g.shape)}"] = smoke._time_ms(
            lambda: mod.kernel(g), ITERS)
        del mod, g
        torch.cuda.empty_cache()
        for tag, cls in (("K3", RdftSpectra), ("K4b", DirectSpectra),
                         ("K6", ChunkSpectra)):
            mod = cls(cfg, hops).to(dev)
            ms[f"{tag} SF8 [16, {hops}]"] = smoke._time_ms(
                lambda: mod.kernel(x8), ITERS)
            del mod
            torch.cuda.empty_cache()
        x, w, v0 = (t.to(dev) for t in probe_inputs(*MAIN_SHAPE))
        p1 = RateProbe()
        ms[f"P1 {list(MAIN_SHAPE)}"] = smoke._time_ms(lambda: p1(x, w),
                                                       2 * ITERS)
        for kind in ("mxu", "vpu", "both"):
            p2 = OverlapProbe(kind)
            ms[f"P2 {kind} {list(MAIN_SHAPE)}"] = smoke._time_ms(
                lambda: p2(x[0], w, v0), 2 * ITERS)
    return {"tree": tree, "card": card, "ms": ms}


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    parent = sys.argv[1]
    change = sys.argv[2] if len(sys.argv) == 3 else str(HERE)
    runs = []
    for label, tree in (("parent", parent), ("change", change),
                        ("change", change), ("parent", parent)):
        out = subprocess.run([sys.executable, str(HERE / "chip_compare.py"),
                              "--one", tree], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            sys.exit(f"{label} run failed ({out.returncode}):\n"
                     f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
        res = json.loads(out.stdout.strip().splitlines()[-1])
        res["label"] = label
        print(json.dumps(res))
        runs.append(res)
    print(f"card: {runs[0]['card']}")
    for key in runs[0]["ms"]:
        got = {lab: [f"{r['ms'][key]:.4f}" for r in runs
                     if r["label"] == lab and key in r["ms"]]
               for lab in ("parent", "change")}
        print(f"{key}: parent {', '.join(got['parent'])} ms; "
              f"change {', '.join(got['change'])} ms")


if __name__ == "__main__":
    main()
