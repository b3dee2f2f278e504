"""BENCHMARK.json against the rules it keeps, every cell resolved to
its files by name, and the imports the benchmark may not make."""

import ast
import hashlib
import json
import os
import re
import shutil

import pytest

from harness import cells

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "generative_models_tpu"}
KEYS = {
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def bench():
    return cells.load_benchmark(ROOT)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_its_rules():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["command"]) <= 32 and all(map(line_ok, b["command"]))
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for word in b["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [c["name"] for c in b["configs"] + b["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == KEYS["config"] and c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                              for k in c["reduced"])
    files = [c["file"] for c in b["configs"]]
    assert len(set(files)) == len(files)
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert line_ok(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        kind = "end_to_end" if m["name"] in e2e else "per_layer"
        assert set(m) - {"workloads"} == KEYS[kind]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and line_ok(m["layer"])
        for w in m["workloads"]:
            assert cells.applies(e2e[m["moves"]], w)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in b["workloads"]:
        reported = [m for m in b["end_to_end"] if cells.applies(m, w["name"])]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) > 1
        moved = {m["name"] for m in reported}
        layer = [m for m in b["per_layer"] if cells.applies(m, w["name"])]
        assert layer and all(m["moves"] in moved for m in layer)


@pytest.mark.parametrize("name", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = cells.resolve(name, ROOT)
    assert cell.driver.Session and cell.reference.leaves
    assert set(cell.readers) == {m["name"] for m in cell.per_layer}
    assert all(callable(r.read) for r in cell.readers.values())
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    for p in (f"traffic/{cell.traffic_name}.json", f"limits/{name}.json",
              f"reference/{cell.config_name}.py"):
        assert os.path.isfile(os.path.join(BENCH, p))


def _py_files(top):
    for root, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def _top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_top_names(p)) & FORBIDDEN)
           for p in _py_files(BENCH)}
    assert not {p: n for p, n in bad.items() if n}


def test_the_references_import_nothing_of_the_port():
    files = list(_py_files(os.path.join(BENCH, "reference")))
    assert len(files) >= 4
    for p in files:
        names = set(_top_names(p))
        assert "generative_models_tpu_torch" not in names, p
        assert names <= {"__future__", "math", "typing", "contextlib",
                         "numpy", "torch", "harness", "reference"}, (p, names)


def _digests(top):
    out = {}
    for root, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            p = os.path.join(root, f)
            out[os.path.relpath(p, top)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_new_cell_config_and_metric_are_new_files_and_entries(tmp_path):
    """A later change adds a cell, its configuration, traffic, limits and
    a per-layer metric as new files and new BENCHMARK.json entries; the
    harness resolves them, and no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root / "gpubench")
    g = root / "gpubench"
    (g / "configs" / "toy-mlp.json").write_text(json.dumps(
        {"name": "toy-mlp", "variant": "ddpm", "trainer": {"hidden_dim": 8}}))
    (g / "reference" / "toy-mlp.py").write_text(
        "def leaves(c):\n    return []\n")
    (g / "traffic" / "gen-n4.json").write_text(json.dumps(
        {"driver": "toy", "n": 4}))
    (g / "drivers" / "toy.py").write_text(
        "class Session:\n    pass\n")
    (g / "limits" / "toy-mlp.gen-n4.json").write_text('{"image_gap": 1.0}')
    (g / "metrics" / "toy_metric.gen.py").write_text(
        "def read(r):\n    return None\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy-mlp", "source": "https://example.org",
                         "file": "gpubench/configs/toy-mlp.json",
                         "reduced": [], "why": "a toy"})
    b["workloads"].append({"name": "toy-mlp.gen-n4", "config": "toy-mlp",
                           "traffic": "gen-n4", "chips": 1, "why": "a toy"})
    for m in b["end_to_end"]:
        if m["name"] == "gen_images_per_s":
            m["workloads"].append("toy-mlp.gen-n4")
    b["per_layer"].append({"name": "toy_metric.gen", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "kernels", "moves": "gen_images_per_s",
                           "workloads": ["toy-mlp.gen-n4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.resolve("toy-mlp.gen-n4", str(root))
    assert cell.config["trainer"] == {"hidden_dim": 8}
    assert cell.traffic["n"] == 4 and cell.limits == {"image_gap": 1.0}
    assert cell.driver.Session and cell.reference.leaves({}) == []
    assert set(cell.readers) == {"toy_metric.gen"}
    assert {m["name"] for m in cell.end_to_end} == {"gen_images_per_s",
                                                     "setup_s"}
    after = _digests(root / "gpubench")
    assert {k: v for k, v in after.items() if k in before} == before
    # the cells that were there resolve as before
    for w in bench()["workloads"]:
        assert cells.resolve(w["name"], str(root)).name == w["name"]
