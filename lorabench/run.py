"""The benchmark of gr_lora_tpu_torch on one NVIDIA GPU.

    python3 -m lorabench.run --workload fsm64.collide --seed 7 \\
        --seconds 20 --trace 0

Runs one cell of ``BENCHMARK.json`` (``lorabench/harness.py``) and prints,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each number the check compared, beside
its limit).  Set-up's parts, the card's clocks and power, and each number
compared beside its limit go to standard error, the last as its last
lines.  Without the cards the cell asks for, or with ``jax``, ``jaxlib``,
``flax`` or ``gr_lora_tpu`` loaded after the window, it prints no result
and exits with a code other than 0.

Build caches stay inside the checkout, at fixed paths: the kernels'
library in ``gr_lora_tpu_torch/_build/`` (the program's own), the CUDA
JIT, Triton and extension caches under ``.lorabench_cache/``.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_CACHE = Path(__file__).resolve().parents[1] / ".lorabench_cache"
for _var, _sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(_CACHE / _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from lorabench import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), t0=T0)
    except harness.NoChip as err:
        print(f"lorabench: {err}", file=sys.stderr)
        return 3
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"lorabench: modules loaded in the run: {forbidden}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
