"""One run of one cell of the benchmark of ``kandinsky2_tpu_torch`` on
NVIDIA GPUs:

    python -m bench_h100.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's file ``workloads/<cell>.json``
names its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``, whose ``kind`` names its runner,
``kinds/<kind>.py``) and the limit of each number its check compares;
``BENCHMARK.json`` at the root names the metrics each cell reports, and a
per-layer metric ``<name>`` is read by ``metrics/<name>.py``, or, where
there is none, by the reader of its family, ``metrics/<name up to the
first dot>.py``.  Set-up (imports, the kernels' build, weights drawn on
the card, the warm-up) is timed from process start; the window then runs
the cell's unit back to back until ``--seconds`` have passed and the last
unit begun has completed.  With ``--trace 1`` the same window runs, and
after it the traffic's ``trace_units`` more units under the profiler; the
per-layer metrics are printed instead of the end-to-end ones, those of
the host's clock read from the untraced window, the rest from the
trace.  Then the program is freed and the check runs the plain
reference.  The last line of standard output is the result, a JSON
object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# Caches at fixed paths inside the checkout, so only a checkout's first run
# builds; the port's own nvcc libraries go to kandinsky2_tpu_torch/build/.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CHECKOUT, ".bench_cache", "torch_ext"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CHECKOUT, ".bench_cache", "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("OMP_NUM_THREADS", "4")

FORBIDDEN = ("jax", "jaxlib", "flax", "kandinsky2_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    """The cell's file with its configuration and traffic loaded."""
    cell = load_json(HERE, "workloads", f"{name}.json")
    cell["name"] = name
    cell["cfg"] = load_json(HERE, "configs", f"{cell['config']}.json")
    cell["tr"] = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    return cell


def cell_metrics(bench: dict, name: str) -> tuple:
    """(end-to-end, per-layer) metric entries of BENCHMARK.json that cell
    ``name`` reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return e2e, per_layer


def reader_path(metric: str) -> str:
    """``metrics/<metric>.py``, else its family's ``metrics/<first part>.py``."""
    own = os.path.join(HERE, "metrics", f"{metric}.py")
    return own if os.path.exists(own) else os.path.join(
        HERE, "metrics", f"{metric.split('.')[0]}.py")


def load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + metric.replace(".", "_").replace("-", "_"), reader_path(metric))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Window:
    """What the per-layer readers see: the traced window (its trace, wall
    seconds, units, counts) and the untraced window before it (``wall_s``,
    ``wall_units``), whose wall time the profiler does not stretch."""

    def __init__(self, trace, window_s, units, counts, work, memory_peak_bytes,
                 wall_s, wall_units):
        self.trace, self.window_s, self.units = trace, window_s, units
        self.counts, self.work, self.memory_peak_bytes = counts, work, memory_peak_bytes
        self.wall_s, self.wall_units = wall_s, wall_units


def make_cell(spec: dict, seed: int, device):
    """The runner of the cell's traffic kind (``kinds/<kind>.py``'s
    ``Cell``), not yet set up."""
    kind = importlib.import_module(f"bench_h100.kinds.{spec['tr']['kind']}")
    return kind.Cell(spec["cfg"], spec["tr"], seed, device)


def run_units(cell, sync, first: int, more) -> tuple:
    """Units ``first``, ``first + 1``, ... back to back, at least one, while
    ``more(units run, seconds since the start)``; then a synchronize.
    Returns (units, items, wall seconds, host seconds of each unit)."""
    units = items = 0
    t0 = time.perf_counter()
    marks = [t0]
    while units == 0 or more(units, marks[-1] - t0):
        items += cell.step(first + units)
        units += 1
        marks.append(time.perf_counter())
    sync()
    return units, items, time.perf_counter() - t0, [b - a for a, b in zip(marks, marks[1:])]


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str) -> dict:
    """Set-up, the window, the check; returns the result object."""
    import torch

    from .trace import Trace, traced

    cell = make_cell(spec, seed, device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_setup = time.perf_counter()
    cell.setup()
    sync()
    setup_s = time.perf_counter() - T_START
    print(f"set-up {setup_s!r} s: to the cell's set-up {t_setup - T_START!r} s, the set-up "
          f"{setup_s - (t_setup - T_START)!r} s", file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    units, items, wall_s, gaps = run_units(cell, sync, 0, lambda n, el: el < seconds)
    print(f"window {wall_s!r} s, {units} units, host ms a unit: "
          + " ".join(f"{1e3 * g:.0f}" for g in gaps), file=sys.stderr)
    attempted = units
    if trace:
        with traced(True) as tr:
            t_units, _, window_s, _ = run_units(
                cell, sync, units, lambda n, el: n < spec["tr"]["trace_units"])
        attempted += t_units
        print(f"traced window {window_s!r} s, {t_units} units, {window_s / t_units!r} s a "
              f"unit against {wall_s / units!r} s untraced", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.free()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = cell.check(attempted)
    print(f"check {time.perf_counter() - t_check!r} s", file=sys.stderr)
    limits = spec["limits"]
    check = {k: {"value": v, "limit": limits[k]} for k, v in readings.items()}
    result = {"correct": all(v <= limits[k] for k, v in readings.items()),
              "attempted": attempted, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": spec["chips"], "memory_peak_bytes": int(peak)}}
    bench = load_json(CHECKOUT, "BENCHMARK.json")
    e2e, per_layer = cell_metrics(bench, spec["name"])
    if trace:
        t = Trace(tr.events or [])
        win = Window(t, window_s, t_units, cell.counts(t_units), cell.work_per_call(), peak,
                     wall_s, units)
        for m in per_layer:
            value = load_reader(m["name"]).read(win)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=t.busy_s, window_s=window_s)
        result["breakdown"] = {"device_ops": t.top_device_ops(), "idle_gaps": t.idle_gaps()}
    else:
        values = dict(cell.end_to_end(wall_s, items), setup_s=setup_s)
        for m in e2e:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result["check"] = check
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"modules that the benchmark may not load: {found}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
