"""BENCHMARK.json and the files it names: allowed names and units, every
per-layer metric reported where its end-to-end metric is, every named
file present, the run length inside the check's budget, and the
configuration files equal to the program's profile."""

import dataclasses
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}
CELLS = [w["name"] for w in MAN["workloads"]]


def _e2e_of(cell):
    return {m["name"] for m in MAN["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_keys(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) <= KEYS[section], set(e) - KEYS[section]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_bounds_and_sources():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_run_seconds_fits_the_check_budget():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = _e2e_of(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = [m for m in MAN["per_layer"] if cell in m["workloads"]]
    assert layers
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert w["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_moves_is_reported_in_each_listed_cell(metric):
    m = next(m for m in MAN["per_layer"] if m["name"] == metric)
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    for cell in m["workloads"]:
        assert cell in CELLS
        assert m["moves"] in _e2e_of(cell)


def test_layers_named_alike_and_readers_present():
    for m in MAN["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    for m in MAN["end_to_end"]:
        assert (PKG / "e2e" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_present(cell):
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
    wl = json.loads((PKG / "workloads" / f"{cell}.json").read_text())
    assert (PKG / "entries" / f"{wl['entry']}.py").is_file()
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file()
    assert conf["file"].startswith("portbench/")


def test_every_config_used_and_its_file_unique():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    sources = [c["source"] for c in MAN["configs"]]
    assert len(sources) == len(set(sources))


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_mapping_cell_runs_its_configs_map_kind(cell):
    """A mapping deployment's file states its map (exact or hybrid); the
    cell's workload file replays and judges that map."""
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    wl = json.loads((PKG / "workloads" / f"{cell}.json").read_text())
    conf = next(c for c in MAN["configs"] if c["name"] == w["config"])
    kind = json.loads((ROOT / conf["file"]).read_text()).get("map_kind")
    if wl["entry"] != "replay_mapping":
        assert kind is None
        return
    assert wl["reference"] == kind
    assert wl["kernel"] == {"exact": "residentx", "hybrid": "hybridx"}[kind]


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_config_file_is_the_program_profile(name):
    """Every group the file states equals the program's profile field for
    field (the file is what both sides run), and `reduced` is empty."""
    from micro_quad_slam_tpu_torch.ops.raycast import DEFAULT_GEOM
    from micro_quad_slam_tpu_torch.utils import config as pc

    entry = next(c for c in MAN["configs"] if c["name"] == name)
    conf = json.loads((ROOT / entry["file"]).read_text())
    prof = getattr(pc, conf["profile"])
    for g in ("map", "tof", "gates", "ekf", "slam", "geom"):
        if g not in conf:
            continue
        src = DEFAULT_GEOM if g == "geom" else getattr(prof, g)
        for k, v in conf[g].items():
            want = getattr(src, k)
            assert (list(want) if isinstance(want, tuple) else want) == v, \
                (g, k)
    assert entry["reduced"] == []
    assert dataclasses.is_dataclass(prof)
