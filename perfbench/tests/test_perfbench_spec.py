"""``BENCHMARK.json`` against the rules it is written to, and every piece a cell
names present under ``perfbench/``."""

import re

import pytest

from harness import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
E2E = {e["name"]: e for e in BENCH["end_to_end"]}


def test_top_level():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.fullmatch(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        assert len({c["name"] for c in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_setup_s_and_an_other_metric_in_every_cell():
    assert "setup_s" in E2E
    for w in BENCH["workloads"]:
        e2e = spec.metrics_for(BENCH, w["name"], trace=False)
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert spec.metrics_for(BENCH, w["name"], trace=True)


def test_moves_names_an_end_to_end_metric_each_of_its_cells_reports():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E, m["name"]
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert cell in E2E[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def test_one_layer_name_per_layer():
    # a layer's metrics give the same name letter for letter: no two spellings
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({name.lower() for name in layers}) == len(layers)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_piece_a_cell_names_is_there(w):
    pieces = spec.config(BENCH, w["config"]), spec.traffic(w["traffic"]), spec.limits(w["name"])
    cfg, _, limits = pieces
    assert set(limits) <= {"loss0_gap", "grad_gap", "grad_proj_gap", "change_gap"} and limits
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("perfbench/configs/")
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    for m in spec.metrics_for(BENCH, w["name"], False) + spec.metrics_for(BENCH, w["name"], True):
        assert callable(spec.reader(m["name"]).read)


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_no_width_is_reduced():
    widths = re.compile(r"hidden|intermediate|latent|state|_dim$|_rank$|head|expand|per_tok")
    for c in BENCH["configs"]:
        cut = [k for k in c["reduced"] if widths.search(k) and not k.endswith("_layers")]
        assert not cut, c["name"]
