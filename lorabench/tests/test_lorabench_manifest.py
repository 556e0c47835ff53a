"""BENCHMARK.json against the benchmark's rules, and every file a cell
is found by."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"_dim$|_rank$|expansion|per_tok)")


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "-m", "lorabench.run"]
    assert MAN["paths"] == ["lorabench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in _metrics()] + \
        [c["name"] for c in MAN["configs"]] + \
        [w[k] for w in MAN["workloads"] for k in ("name", "config",
                                                   "traffic")]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in _metrics())
    for group in (_metrics(), MAN["configs"], MAN["workloads"]):
        assert len({e["name"] for e in group}) == len(group)
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) \
        == len(MAN["workloads"])
    for text in ([c["source"] for c in MAN["configs"]]
                 + [w["why"] for w in MAN["workloads"] + MAN["configs"]]
                 + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_metric_entries():
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(m["better"] in ("lower", "higher") for m in _metrics())


def _reports(cell, group):
    return {m["name"] for m in MAN[group]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_what_its_layers_move(cell):
    e2e = _reports(cell, "end_to_end")
    layers = _reports(cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in MAN["per_layer"]:
        if m["name"] in layers:
            assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(cell):
    pkg = ROOT / "lorabench"
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert cell["chips"] in (1, 4)
    config = json.loads((pkg / "configs" / f"{cell['config']}.json")
                        .read_text())
    assert (pkg / "traffic" / f"{cell['traffic']}.json").exists()
    engine = importlib.import_module(f"lorabench.engines.{config['engine']}")
    assert engine.FEED_AS in ("numpy", "tensor")
    limits = json.loads((pkg / "limits" / f"{cell['name']}.json").read_text())
    assert {"pdu_missing_pct", "pdu_extra"} <= set(limits)
    for m in _reports(cell["name"], "end_to_end") | \
            _reports(cell["name"], "per_layer"):
        assert callable(importlib.import_module(f"lorabench.metrics.{m}")
                        .read)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_configurations(entry):
    path = ROOT / entry["file"]
    assert entry["file"].startswith("lorabench/")
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert not any(WIDTHS.search(k) for k in entry["reduced"])
    assert len({c["file"] for c in MAN["configs"]}) == len(MAN["configs"])
    from gr_lora_tpu_torch import LoraConfig
    from gr_lora_tpu_torch.config import PeakSearch

    lora = dict(config["lora"], peak_search=PeakSearch(
        config["lora"]["peak_search"]))
    assert LoraConfig(**lora).replace() == LoraConfig(**lora)
    assert set(config["lora"]) == set(LoraConfig.__dataclass_fields__)
