"""CPU tests of the harness: `BENCHMARK.json` against the contract's
character rules, the imports, the run without a card, discovery by
name, and that the comparison fails the control and planted faults.

    python -m pytest -q -p no:cacheprovider gpubench/tests
"""

import ast
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "gpubench")
sys.path.insert(0, ROOT)

from gpubench import cell, check  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "brutus_tpu"}

# a run at a size the CPU holds: the cells' code paths on a small grid
SHRINK = {
    "funnel.survey16k": {
        "grid": {"n_model": 20000}, "fit": {"screen_k": 2048,
                                            "n_sel_max": 512},
        "traffic": {"call_stars": {"fixed": 40}, "pool_calls": 2},
        "settings": {"keep_rows_per_call": 8, "check_stars": 12,
                     "trace_calls": 1}},
    "funnel.sightline": {
        "grid": {"n_model": 20000}, "fit": {"screen_k": 2048,
                                            "n_sel_max": 512,
                                            "batch_size": 8},
        "traffic": {"call_stars": {"log_uniform": [16, 40],
                                   "distinct": 2}},
        "settings": {"keep_rows_per_call": 8, "check_stars": 12,
                     "trace_calls": 2}},
}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_units_and_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(HERE, "workloads",
                                           w["name"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))
    for text in [w["why"] for w in b["workloads"]] + [
            m["layer"] for m in b["per_layer"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_and_the_reference_not_the_program():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                found = set(_imports(os.path.join(dirpath, f)))
                assert not found & FORBIDDEN, (f, found & FORBIDDEN)
    for f in ("reference.py", "check.py", "traffic.py", "counts.py"):
        assert "brutus_tpu_torch" not in set(
            _imports(os.path.join(HERE, f))), f


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "funnel.survey16k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_in_a_folder_without_the_program_fails(tmp_path):
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        "funnel.survey16k", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_cpu_run_writes_no_device_metric():
    """A CPU run (tests only) reports the platform "cpu" and no trace
    reading of the card: every device-trace metric is left out."""
    r = cell.run("funnel.survey16k", 5, 1.0, True, time.perf_counter(),
                 device="cpu", shrink=SHRINK["funnel.survey16k"])
    assert r["device"]["platform"] == "cpu"
    device_metrics = {m["name"] for m in bench()["per_layer"]
                      if m["source"] == "device_trace"}
    assert not set(r["metrics"]) & device_metrics
    assert "busy_s" not in r["device"]


def test_new_config_cell_and_metric_are_found_by_name(tmp_path):
    """A throwaway configuration, traffic mix, cell and metric added as
    files (and entries) to a copy are picked up with no edit."""
    shutil.copytree(HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    g = tmp_path / "gpubench"
    conf = json.load(open(g / "configs" / "mist750k_ps1_2mass_funnel.json"))
    conf["grid"]["n_model"] = 20000
    conf["fit"].update(screen_k=2048, n_sel_max=512)
    json.dump(conf, open(g / "configs" / "tiny_lattice.json", "w"))
    mix = json.load(open(g / "traffic" / "survey16k.json"))
    mix.update(call_stars={"fixed": 32}, pool_calls=2)
    json.dump(mix, open(g / "traffic" / "tiny32.json", "w"))
    json.dump(dict(trace_calls=1, keep_rows_per_call=4, check_stars=4,
                   limits={"cov_dev": 1e9}),
              open(g / "workloads" / "tiny.cell.json", "w"))
    (g / "metrics" / "stars_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.stars)\n")
    b["configs"].append(dict(name="tiny_lattice", source="test",
                             file="gpubench/configs/tiny_lattice.json",
                             reduced=[], why="test"))
    b["workloads"].append(dict(name="tiny.cell", config="tiny_lattice",
                               traffic="tiny32", chips=1, why="test"))
    b["per_layer"].append(dict(name="stars_traced", unit="stars",
                               better="higher", source="program_counter",
                               layer="entry", moves="stars_per_s",
                               workloads=["tiny.cell"]))
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    r = cell.run("tiny.cell", 3, 1.0, True, time.perf_counter(),
                 device="cpu", root=str(tmp_path))
    assert r["metrics"]["stars_traced"]["value"] == 32.0
    assert r["correct"] and set(r["checks"]) == {"cov_dev"}
    r = cell.run("tiny.cell", 3, 0.5, False, time.perf_counter(),
                 device="cpu", root=str(tmp_path))
    assert set(r["metrics"]) == {"stars_per_s", "setup_s"}


def _records(name, seed):
    c = cell.Cell(name, seed, "cpu", shrink=SHRINK[name])
    for i in range(2):
        c.call(i)
    st = c.s["settings"]
    recs = check.sample(c.kept, st["check_stars"], seed, 0, 1)
    return c, recs


@pytest.mark.parametrize("name", sorted(SHRINK))
def test_the_control_is_not_correct(name):
    """The reference in TF32 put in the program's place fails the
    cell's limits (at a size the CPU holds; on the card the control is
    read at the cells' own sizes, PERF.md)."""
    c, recs = _records(name, 11)
    args = (recs, c.cats, c.mc, c.labels, c.dmap, c.s["config"]["fit"],
            "cpu", 11)
    sound = check.numbers(*args)
    control = check.numbers(*args, prec="tf32")
    limits = c.s["settings"]["limits"]
    assert check.judge(sound, limits)[0]
    assert not check.judge(control, limits)[0]


def _fault(monkeypatch, kind):
    """Break the timed path underneath the harness."""
    from brutus_tpu_torch import fitting
    if kind == "early_stop":
        # the fit kernel stops after two magnitude and two flux steps
        monkeypatch.setattr(fitting, "FitConfig", functools.partial(
            fitting.FitConfig, kernel_mag_iters=2, kernel_flux_iters=2))
        return
    last = {}
    for step in ("_funnel_step", "_dense_step"):
        orig = getattr(fitting, step)

        def broken(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            if kind == "state_unchanged":
                # each batch hands on the state the step had: the answers
                # of the previous batch of its size
                key = out["av"].shape
                prev = last.get(key)
                last[key] = out
                if prev is not None:
                    out = prev
            elif kind == "half_batch":
                # half of the batch left out: its rows take the kept
                # half's answers
                B = out["model_idx"].shape[0]
                h = (B + 1) // 2
                out = {key: torch.cat([v[:h], v[:B - h]]) if v.dim() else v
                       for key, v in out.items()}
            elif kind == "answer_altered":
                out = dict(out, av=out["av"] + 0.05)
            return out
        monkeypatch.setattr(fitting, step, broken)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered", "early_stop"])
@pytest.mark.parametrize("name", sorted(SHRINK))
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, kind):
    """The rest of a run on the CPU (no look for a card), with the timed
    path broken underneath: `correct` comes out false.  (The cells run
    on one card, so no exchange between chips can be left out.)"""
    _fault(monkeypatch, kind)
    r = cell.run(name, 13, 0.5, False, time.perf_counter(), device="cpu",
                 shrink=SHRINK[name])
    assert r["correct"] is False, r["checks"]
