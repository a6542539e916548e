"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]] \
        + [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_bounds_and_sources(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_moves_name_metrics_each_listed_cell_reports(manifest):
    """Every `moves` is an end-to-end metric, reported by every cell the
    layer metric lists (end-to-end metrics without `workloads` are
    reported by every cell)."""
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e, m
        listed = set(m.get("workloads", cells))
        assert listed <= cells and listed <= e2e[m["moves"]], m


def test_every_cell_reports_setup_another_metric_and_a_layer(manifest):
    for w in manifest["workloads"]:
        e2e = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in manifest["per_layer"])


def test_files_the_manifest_names(manifest):
    assert manifest["paths"] == ["port_bench"]
    assert manifest["command"] == ["python3", "port_bench/run.py"]
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        assert c["file"].startswith("port_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)
    for w in manifest["workloads"]:
        for sub in (f"traffic/{w['traffic']}.json", f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(ROOT, "port_bench", sub)), sub
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "port_bench", "metrics", f"{m['name']}.py"))


def test_config_files_state_their_changes(manifest):
    """`reduced` lists every key the file changes from its repo config, and
    no width."""
    import yaml

    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            conf = json.load(fh)
        assert conf["reduced"] == c["reduced"]
        assert set(conf["changed"]) == set(c["reduced"])
        with open(os.path.join(ROOT, conf["repo_config"])) as fh:
            repo = yaml.safe_load(fh)
        assert conf["trainer"] == repo
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank")) and k not in ("heads", "layers")
