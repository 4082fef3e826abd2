"""``BENCHMARK.json``: loading, the naming rules, and a cell's parts.

A cell names a configuration and a traffic mix; its end-to-end metrics
are those whose ``workloads`` list it (or that have no such list), and
its per-layer metrics likewise.  Files are found by name under the
benchmark's own directory, so a new cell, mix, configuration or metric
is a new file plus a new entry, never an edit.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
# Each group: its entries' keys (a metric may add ``workloads``) and how
# many entries it may hold.
KEYS = {"configs": ({"name", "source", "file", "reduced", "why"}, 24),
        "workloads": ({"name", "config", "traffic", "chips", "why"}, 24),
        "end_to_end": ({"name", "unit", "better", "bound", "source"}, 16),
        "per_layer": ({"name", "unit", "better", "source", "layer",
                       "moves"}, 128)}


@dataclass
class Cell:
    """One entry of ``workloads`` with what it needs resolved."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(root: Path, rel: str) -> dict:
    with open(root / rel) as fh:
        return json.load(fh)


def cell(root: Path, name: str) -> Cell:
    """Resolve cell ``name`` against the manifest at ``root``."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_json(root, conf["file"])
    traffic = read_json(root / HERE.name / "traffic",
                        f"{entry['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(entry["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])


def problems(bench: dict, root: Path) -> List[str]:
    """Breaches of the manifest's naming and shape rules (empty: none)."""
    out: List[str] = []
    seen: Dict[str, set] = {"config": set(), "cell": set(), "metric": set()}

    def line_ok(what: str, text) -> None:
        if (not isinstance(text, str) or not 1 <= len(text) <= 200
                or "\n" in text or "\t" in text):
            out.append(f"{what}: not 1 to 200 characters on one line")

    if set(bench) != TOP:
        return [f"top-level keys {sorted(bench)} are not {sorted(TOP)}"]
    for group, (keys, most) in KEYS.items():
        if not 1 <= len(bench[group]) <= most:
            out.append(f"{group}: {len(bench[group])} entries")
        for e in bench[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            if not keys <= set(e) <= keys | extra:
                out.append(f"{group} entry {e.get('name')!r} has keys "
                           f"{sorted(e)}, not {sorted(keys)}")
                return out
    cmd = bench["command"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        out.append("command is not a list of 1 to 32 words")
    for word in cmd:
        line_ok("command word", word)
    if not 1 <= len(bench["paths"]) <= 16:
        out.append("paths: not 1 to 16 directories")
    for p in bench["paths"]:
        if (not PATH.match(p) or p.startswith("/")
                or ".." in p.split("/")):
            out.append(f"path {p!r} breaks the path rule")
    rs = bench["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        out.append(f"run_seconds {rs!r} is not a whole number 1 to 51")

    def name_ok(kind: str, value: str) -> None:
        if not isinstance(value, str) or not NAME.match(value):
            out.append(f"{kind} name {value!r} breaks the naming rule")

    for c in bench["configs"]:
        name_ok("config", c["name"])
        for key in c["reduced"]:
            name_ok("reduced key", key)
        if c["name"] in seen["config"]:
            out.append(f"config {c['name']} twice")
        seen["config"].add(c["name"])
        if not (root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in bench["paths"]):
            out.append(f"config file {c['file']} outside paths")
        if len(c["reduced"]) > 16:
            out.append(f"config {c['name']}: more than 16 reduced keys")
        line_ok(f"config {c['name']} source", c["source"])
        line_ok(f"config {c['name']} why", c["why"])
    pairs = set()
    for w in bench["workloads"]:
        name_ok("cell", w["name"])
        name_ok("traffic", w["traffic"])
        if w["name"] in seen["cell"]:
            out.append(f"cell {w['name']} twice")
        seen["cell"].add(w["name"])
        if w["config"] not in seen["config"]:
            out.append(f"cell {w['name']} names unknown config")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']} repeats a config and traffic pair")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']} asks for {w['chips']} chips")
        if not (root / HERE.name / "traffic"
                / f"{w['traffic']}.json").is_file():
            out.append(f"traffic file of {w['traffic']} missing")
        line_ok(f"cell {w['name']} why", w["why"])
    for kind, group in (("end_to_end", bench["end_to_end"]),
                        ("per_layer", bench["per_layer"])):
        for m in group:
            name_ok("metric", m["name"])
            if m["name"] in seen["metric"]:
                out.append(f"metric {m['name']} twice")
            seen["metric"].add(m["name"])
            if not UNIT.match(m["unit"]):
                out.append(f"metric {m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"metric {m['name']}: better {m['better']!r}")
            if kind == "end_to_end" and not (
                    isinstance(m["bound"], (int, float))
                    and 0.01 <= m["bound"] <= 0.25):
                out.append(f"metric {m['name']}: bound {m['bound']!r}")
            if kind == "per_layer":
                line_ok(f"metric {m['name']} layer", m["layer"])
            allowed = SOURCES_E2E if kind == "end_to_end" else SOURCES
            if m["source"] not in allowed:
                out.append(f"metric {m['name']}: source {m['source']!r}")
            for w in m.get("workloads", ()):
                if w not in seen["cell"]:
                    out.append(f"metric {m['name']} lists unknown cell {w}")
            if not (root / HERE.name / "metrics"
                    / f"{m['name']}.py").is_file():
                out.append(f"metric {m['name']} has no reader")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']} moves unknown {m['moves']}")
            continue
        for w in m.get("workloads", [x["name"] for x in bench["workloads"]]):
            if not applies(e2e[m["moves"]], w):
                out.append(f"metric {m['name']}: {w} lacks {m['moves']}")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for c in bench["configs"]:
        if not any(w["config"] == c["name"] for w in bench["workloads"]):
            out.append(f"config {c['name']} is used by no cell")
    for w in bench["workloads"]:
        mine = [m for m in bench["end_to_end"] if applies(m, w["name"])]
        if len(mine) < 2:
            out.append(f"cell {w['name']} reports too few end-to-end metrics")
        if not any(applies(m, w["name"]) for m in bench["per_layer"]):
            out.append(f"cell {w['name']} reports no per-layer metric")
    return out
