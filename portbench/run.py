"""Run one cell of the port's benchmark and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration names its engine, ``portbench/engines/<engine>.py``,
which sets up from the seed, measures for ``--seconds`` and checks what the
timed path produced against the plain reference. With ``--trace 0`` the
line carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, each read by ``portbench/metrics/<name>.py`` from a
traced part of the run. Exits non-zero without a result when the
configuration names no detector architecture of ``portbench/architectures/``
or states other number-format stages than it reads, when the machine has
fewer CUDA cards than the cell asks for, or when JAX or the JAX package is
loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import importlib  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import architectures  # noqa: E402
from portbench.harness import common  # noqa: E402


def read_metric(name: str, ctx: dict, metrics_dir: str = os.path.join(common.PORTBENCH,
                                                                      "metrics")):
    """``portbench/metrics/<name>.py``'s ``read(ctx)``: a number or None."""
    path = os.path.join(metrics_dir, name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def main(argv=None) -> int:
    args = common.parse_args(argv)
    cell = common.load_cell(args.workload)
    common.prepare_process()
    architectures.of(cell.config)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        common.fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    engine = importlib.import_module(f"portbench.engines.{cell.config['engine']}")
    out = engine.run(cell, args, torch.device("cuda", 0), T0)

    bad = common.forbidden_modules()
    if bad:
        common.fail(f"modules of JAX or the JAX package are loaded: {bad}")
    values = dict(out["end_to_end"])
    breakdown = None
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = read_metric(m["name"], out["context"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = out["context"]["trace"]["breakdown"]
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    counts = dict(out.get("counts") or {})
    if args.trace:
        device["busy_s"] = out["context"]["trace"]["busy_s"]
        device["window_s"] = out["context"]["trace"]["window_s"]
        counts["traced_device_ops"] = out["context"]["trace"]["n_device_ops"]
    common.emit(out["correct"], out["attempted"], out["failed"], metrics, device, out["checks"],
                breakdown, counts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
