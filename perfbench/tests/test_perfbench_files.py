"""The benchmark's files: everything BENCHMARK.json names is found by name,
a configuration with an operation the plain walk lacks, a kind of traffic,
a mix and a metric added as new files alone run, nothing imports JAX or the
JAX package, and the references import nothing of the program."""

import ast
import json
import re
import shutil
from pathlib import Path

from perfbench.core import harness, ir, spec

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "pyopenvino_tpu"}


def _imports(path: Path):
    """Every module name a file imports, whole (``a.b`` for ``import a.b``)."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _local_closure(path: Path):
    """``path`` and every perfbench module it imports, transitively."""
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for name in _imports(p):
            if name.split(".")[0] == "perfbench":
                target = ROOT.joinpath(*name.split(".")).with_suffix(".py")
                if not target.exists():
                    target = ROOT.joinpath(*name.split("."), "__init__.py")
                todo.append(target)
    return seen


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    # the port's name begins with the JAX package's: the whole top-level name counts
    assert "pyopenvino_tpu_torch".split(".")[0] not in FORBIDDEN


def test_references_import_nothing_of_the_program():
    refs = sorted((HERE / "reference").glob("*.py"))
    assert refs
    for ref in refs:
        for path in _local_closure(ref):
            tops = {name.split(".")[0] for name in _imports(path)}
            assert not tops & (FORBIDDEN | {"pyopenvino_tpu_torch"}), (ref, path, tops)


def test_only_system_py_imports_the_program():
    users = {p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
             if p.parent.name != "tests"
             and any(n.split(".")[0] == "pyopenvino_tpu_torch" for n in _imports(p))}
    assert users == {"core/system.py"}


def test_every_cell_finds_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert Path(cell.config["xml"]).exists()
        assert hasattr(spec.module("reference", cell.config["name"]), "Reference")
        assert callable(harness.driver(cell))
        for m in cell.per_layer:
            assert callable(spec.module("metrics", m["name"]).read)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


REDUCE_REFERENCE = '''"""ResNet-18 with its global pool a ReduceMean: the plain INT8-FULL
reference and the one operation core/plain.py lacks."""

from perfbench.core import plain
from perfbench.core.int8full import Int8FullReference


def reduce_mean(layer, xs, dtype):
    axes = tuple(i for i, (a, b) in enumerate(zip(layer.in_shapes[0], layer.out_shape))
                 if a != b)
    return plain.round_to(xs[0].mean(dim=axes, keepdim=True), dtype)


class Reference(Int8FullReference):
    OPS = {"ReduceMean": reduce_mean}
'''


def _reduce_mean_topology(xml: str, blob_size: int) -> str:
    """ResNet-18's IR with its AvgPool over 7 x 7 a ReduceMean over the axes
    of a new integer Const (2, 3), which the ``.bin`` holds past its end."""
    m = re.search(r'<layer id="(\d+)" name="[^"]*" type="AvgPool".*?</layer>', xml, re.S)
    lid, old = m.group(1), m.group(0)
    new = re.sub(r'type="AvgPool" version="opset1">\s*<data [^>]*/>',
                 'type="ReduceMean" version="opset1">\n      <data keep_dims="true" />', old)
    new = new.replace('<port id="1" precision="FP32">', '<port id="2" precision="FP32">')
    new = new.replace("</input>", '  <port id="1" precision="I64">\n          <dim>2</dim>\n'
                      '        </port>\n      </input>')
    axes = ('    <layer id="9000" name="reduce_axes" type="Const" version="opset1">\n'
            f'      <data element_type="i64" shape="2" offset="{blob_size}" size="16" />\n'
            '      <output>\n        <port id="0" precision="I64">\n          <dim>2</dim>\n'
            '        </port>\n      </output>\n    </layer>\n')
    xml = xml.replace(old, new).replace("  </layers>", axes + "  </layers>")
    xml = xml.replace(f'<edge from-layer="{lid}" from-port="1"',
                      f'<edge from-layer="{lid}" from-port="2"')
    return xml.replace("  </edges>", f'    <edge from-layer="9000" from-port="0" '
                       f'to-layer="{lid}" to-port="1" />\n  </edges>')


ONE_PASS_DRIVER = '''"""one_pass: every batch of the pool once a window, no warm-up."""

import time

import numpy as np

from perfbench.core import system, traffic
from perfbench.core.window import Window


def run(exe, graph, mix, seed, device, seconds, tracers):
    frames, pool = traffic.closed_batch(graph, mix, seed, device)
    name, result = system.input_name(exe), system.result_name(exe)
    b = int(mix["batch"])
    windows = []
    for tracer in tracers:
        with tracer.profiling(), tracer.window():
            t0 = time.perf_counter()
            answers = [(np.arange(k * b, (k + 1) * b), exe.infer_batch({name: p})[result])
                       for k, p in enumerate(pool)]
            t1 = time.perf_counter()
        n = len(pool) * b
        windows.append(Window(start=t0, seconds=t1 - t0, attempted=n, failed=0,
                              metrics={"throughput": n / (t1 - t0)}, answers=answers,
                              counts={"calls": len(pool), "images": n}))
    return frames, windows
'''


def test_a_new_config_kind_mix_and_metric_are_new_files_only(tmp_path):
    """A copy of the benchmark with a configuration whose topology has an
    operation that core/plain.py lacks (ResNet-18 with its global pool a
    ReduceMean over an integer Const's axes), a kind of traffic, a mix and a metric added as files and entries, and
    no file edited but BENCHMARK.json, runs its new cell on the CPU,
    correct, and reports the new metric."""
    base = tmp_path / "perfbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    src = "resnet18.int8full.bf16"
    new = "resnet18.reduce_mean"
    assert "ReduceMean" not in (HERE / "core" / "plain.py").read_text()
    cfg = json.loads((HERE / "configs" / f"{src}.json").read_text())
    xml = _reduce_mean_topology((HERE / "configs" / f"{src}.xml").read_text(),
                                ir.parse(spec.config(src)["xml"]).blob_size)
    (base / "configs" / f"{new}.xml").write_text(xml)
    cfg.update(topology=f"{new}.xml", int_consts={"reduce_axes": [2, 3]})
    (base / "configs" / f"{new}.json").write_text(json.dumps(cfg))
    (base / "reference" / f"{new}.py").write_text(REDUCE_REFERENCE)
    (base / "drivers" / "one_pass.py").write_text(ONE_PASS_DRIVER)
    (base / "traffic" / "tiny_pass.json").write_text(json.dumps(
        {"kind": "one_pass", "batch": 2, "pool": 2}))
    (base / "metrics" / "frames_answered.tiny.py").write_text(
        "def read(r):\n    return r.window.counts.get('images')\n")
    bench["configs"].append({"name": new, "source": cfg["source"],
                             "file": f"perfbench/configs/{new}.json", "reduced": [],
                             "why": "a copy"})
    bench["workloads"].append({"name": "copy.tiny", "config": new, "traffic": "tiny_pass",
                               "chips": 1, "why": "a copy"})
    bench["per_layer"].append({"name": "frames_answered.tiny", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "Serving", "moves": "throughput",
                               "workloads": ["copy.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "throughput":
            m["workloads"].append("copy.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("copy.tiny", base=base)
    assert cell.config["xml"].startswith(str(base))
    types = {layer.type for layer in ir.parse(cell.config["xml"])}
    assert "ReduceMean" in types and "AvgPool" not in types
    out = harness.run(cell, 2**31 + 3, 0.5, True, "cpu", harness.process_start(), lambda s: None)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["frames_answered.tiny"]["value"] == 4
    assert out["attempted"] == 8   # two windows, traced and not, of one pass each
    assert "frames_answered.tiny" not in spec.cell("r18.bulk512").per_layer


def test_the_result_line_keys():
    cell = spec.cell("mnv2.bulk512")
    cell.traffic.update(batch=2, pool=1, warmup_calls=1)
    lines = []
    out = harness.run(cell, 2**31 + 19, 0.5, False, "cpu", harness.process_start(), lines.append)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"throughput", "setup_s"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(out["checks"]) == ["top1_gap", "tv_mean", "kl_max"]
    # the numbers compared, each beside its limit, are the last lines logged
    assert [line.split()[1] for line in lines[-3:]] == ["top1_gap", "tv_mean", "kl_max"]
    assert all("limit" in line for line in lines[-3:])
    json.dumps(out, allow_nan=False)
