"""The harness finds its configurations, mixes, kinds, limits and metric
readers by name; a cell, a mix, a kind and a metric added as files need no
edit to a file that is there; the import check compares whole top-level names; the
command refuses to run without a card."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run as harness  # noqa: E402


def _load_run(path: Path):
    spec = importlib.util.spec_from_file_location("copied_run", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_cell_resolves_by_name():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        c, conf, mix = harness.cell_files(bench, cell["name"])
        limits = harness.load_json(harness.BENCH / "limits"
                                   / f"{cell['name']}.json")
        assert conf["name"] == cell["config"]
        assert callable(harness.kind(mix["kind"]))
        assert limits and all(isinstance(v, (int, float))
                              for v in limits.values())
        names = [m["name"] for m in harness.per_layer(bench, cell["name"])]
        assert names, cell["name"]
        for name in names:
            assert callable(harness.reader(name))
        e2e = {m["name"] for m in harness.end_to_end(bench, cell["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2


LUA = {"gdc2020": "config/gdc_2020_config.lua"}


@pytest.mark.parametrize("name", sorted(LUA))
def test_config_files_hold_the_source_keys(name):
    """Each configuration file holds the Lua file's keys as run; a key that
    differs is listed in ``reduced``, here and in BENCHMARK.json."""
    from nautilus_tpu_torch.core.luaconf import load_config
    conf = harness.load_json(harness.BENCH / "configs" / f"{name}.json")
    source = load_config(ROOT / LUA[name]).values
    assert set(conf["keys"]) == set(source)
    changed = sorted(k for k, v in source.items() if conf["keys"][k] != v)
    assert changed == sorted(conf["reduced"])
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for entry in bench["configs"]:
        if entry["name"] == name:
            assert entry["reduced"] == conf["reduced"]


def test_a_new_cell_mix_kind_and_metric_are_files_only(tmp_path):
    for name in ("portbench",):
        shutil.copytree(ROOT / name, tmp_path / name,
                        ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    pb = tmp_path / "portbench"
    (pb / "traffic" / "solve_map.json").write_text(json.dumps(
        {"kind": "closed_map", "auto_lc": False, "drifts": [1, 2],
         "check_csm_pairs": 0, "gate_band": 0.1}))
    (pb / "limits" / "gdc2020.solve_map.json").write_text(
        json.dumps({"sweep_gap": 1e-4}))
    (pb / "metrics" / "solve.windows.py").write_text(
        "def read(run):\n    return 10.0\n")
    (pb / "traffic" / "replay.json").write_text(json.dumps({"kind": "replay"}))
    (pb / "kinds" / "replay.py").write_text(
        "from portbench import traffic\n\n\n"
        "def drive(mix, conf, seed, seconds, trace, device, t_start):\n"
        "    run = traffic.Run('map_s', value=1.0, attempted=1)\n"
        "    return run, lambda k=None: {'replay_gap': 0.0}\n")
    (pb / "limits" / "gdc2020.replay.json").write_text(
        json.dumps({"replay_gap": 0.0}))
    bench["workloads"].append({"name": "gdc2020.solve_map", "config": "gdc2020",
                               "traffic": "solve_map", "chips": 1,
                               "why": "a later cell"})
    bench["workloads"].append({"name": "gdc2020.replay", "config": "gdc2020",
                               "traffic": "replay", "chips": 1,
                               "why": "a later kind"})
    bench["per_layer"].append({"name": "solve.windows", "unit": "windows",
                               "better": "lower", "source": "program_counter",
                               "layer": "solve", "moves": "map_s",
                               "workloads": ["gdc2020.solve_map"]})
    bench["end_to_end"][1]["workloads"].append("gdc2020.solve_map")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    copied = _load_run(pb / "run.py")
    cell, conf, mix = copied.cell_files(bench, "gdc2020.solve_map")
    assert mix["auto_lc"] is False and conf["name"] == "gdc2020"
    assert copied.load_json(pb / "limits" / "gdc2020.solve_map.json") \
        == {"sweep_gap": 1e-4}
    assert [m["name"] for m in copied.per_layer(bench, "gdc2020.solve_map")] \
        == ["solve.windows"]
    assert copied.reader("solve.windows")(None) == 10.0
    run, judge, _, limits = copied.measure("gdc2020.replay", 1, 0.1, False,
                                           "cpu", bench)
    assert copied.verdict(run, judge(), limits)[0]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in pb.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_import_check_compares_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    for name in ("nautilus_tpu_torch", "nautilus_tpu_torch.solve",
                 "jaxtyping", "flaxen"):
        fake.setdefault(name, object())
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == []
    fake["jaxlib.xla_client"] = object()
    fake["nautilus_tpu.core"] = object()
    assert harness.forbidden_modules() == ["jaxlib", "nautilus_tpu"]


def test_refuses_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is for machines "
                    "without one")
    rc = harness.main(["--workload", "gdc2020.autolc_map", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
