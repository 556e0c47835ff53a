"""The check that decides ``correct``, at a size a CPU test run holds:
the program passes it, the control (the reference one precision below
the configuration's, in the program's place) fails it, and so does a run
with the timed path broken underneath, once for each fault a cell can
have.  The harness's look for a chip is skipped (``device="cpu"``: the
program's plain versions); the rest of a run is driven as on the card.
One chip: no cell has an exchange between chips to leave out.
"""

import json
from pathlib import Path

import pytest

from lorabench import harness

LIMITS = Path(__file__).resolve().parents[1] / "limits"
SMALL = {"traffic": {"samples_per_feed": 1 << 17, "pool_feeds": 2},
         "config": {"channels": 2, "sfs": [7, 8]}}
SEED = 2**31 + 4242


def _run(cell, control=False, seconds=3.0):
    return harness.run(cell, SEED, seconds, False, device="cpu",
                       overrides=json.loads(json.dumps(SMALL)),
                       control=control)


def _limits(cell):
    return json.loads((LIMITS / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", ["fsm64.collide", "fsm64.sparse"])
def test_program_passes_and_control_fails(cell):
    res = _run(cell, control=True)
    assert res["correct"], res["checks"]
    limits = _limits(cell)
    assert any(v > limits[k] for k, v in res["control"].items()), \
        (res["control"], limits)


def _flip(decode):
    def wrong(symbols, cfg):
        res = decode(symbols, cfg)
        if res.ok and len(res.payload) > 4:
            res.payload[4] ^= 0x01
        return res
    return wrong


@pytest.mark.parametrize("cell", ["fsm64.collide", "fsm64.sparse"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "pdu_byte",
                                   "snr"])
def test_fsm_faults_fail_the_check(fault, cell, monkeypatch):
    from gr_lora_tpu_torch.dist import triggered

    if fault == "unchanged":
        monkeypatch.setattr(triggered.TriggeredReceiver, "__call__",
                            lambda self, iq: [])
    elif fault == "pdu_byte":
        monkeypatch.setattr(triggered, "decode", _flip(triggered.decode))
    else:
        make = triggered.demod_fn

        def broken(*args, **kw):
            demod = make(*args, **kw)

            def call(iq):
                syms, lens, pos, cnt, dropped, snr = demod(iq)
                if fault == "half_batch":
                    cnt = cnt.clone()
                    cnt[cnt.shape[0] // 2:] = 0
                else:
                    snr = snr * 1.001
                return syms, lens, pos, cnt, dropped, snr
            return call
        monkeypatch.setattr(triggered, "demod_fn", broken)
    res = _run(cell, seconds=0.1)
    assert not res["correct"], res["checks"]
