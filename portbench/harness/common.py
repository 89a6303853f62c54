"""What every engine of the benchmark shares: the command line, the files a
cell is made of, the environment, the checks on the process and the
result's last line."""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass

FORBIDDEN = ("jax", "jaxlib", "flax", "vdetlib_tpu")
PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration and mix."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``: its configuration
    file, its mix ``portbench/traffic/<traffic>.json`` and the metrics that
    apply to it."""
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", w["traffic"] + ".json"),
              encoding="utf-8") as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def prepare_process(root: str = ROOT) -> None:
    """Caches at fixed paths inside the checkout; no JAX through libraries."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 3):
    print(msg, file=sys.stderr, flush=True)
    raise SystemExit(code)


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         checks: list, breakdown: dict | None = None, counts: dict | None = None) -> None:
    """The checks on standard error (its last lines), then the result's line,
    last on standard output, its own key ``checks`` last. ``checks``:
    (name, value, limit); ``counts``: what the window did, for the record."""
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {correct}", file=sys.stderr, flush=True)
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if counts:
        out["counts"] = counts
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(out), flush=True)


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """Every number against its limit (a number passes at or below it; a
    number without a limit fails)."""
    checks = [(k, numbers[k], limits[k]) for k in limits]
    return all(lim is not None and v <= lim for _, v, lim in checks), checks
