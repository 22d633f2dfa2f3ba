"""Run one cell of the benchmark of popcorn_tpu_torch, once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The run
finds the cell in BENCHMARK.json and its files by name (harness/spec.py),
makes or reuses the cell's region under port_bench/.cache/, sets up the
cell's driver (drivers/<driver>.py: the program's entry, weights drawn
from --seed, warm-up), measures for --seconds, reads the peak device
memory, frees the program's state, compares what the timed path
produced with the plain reference (reference/), and prints one JSON line
last on standard output: 'correct', 'attempted', 'failed', 'metrics'
(the cell's end-to-end metrics, or with --trace 1 its per-layer metrics,
read by metrics/<name>.py from the run's record and a device trace of a
few units run after the window) and 'device', then 'checks': each number
compared with its limit, which also end standard error. It measures
nothing without a card and imports neither JAX nor the JAX package.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "popcorn_tpu")
CACHE = os.path.join(BENCH_DIR, ".cache")


class Run:
    """What one run's driver works with and leaves for the check."""

    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.dda_path = os.path.join(ROOT, "weights",
                                     "fusionda_newAug8_16_checkpoint30_lossweight0.5.pt")
        self.scratch = os.path.join(tempfile.gettempdir(), "port_bench_run")
        self.data_root = None
        self.notes = {}

    def sync(self) -> None:
        """Wait for the device's queued work (none on the CPU)."""
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def tmp(self, name: str) -> str:
        path = os.path.join(self.scratch, name)
        os.makedirs(path, exist_ok=True)
        return path


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def prepare_data(run, cache: str = CACHE) -> None:
    """The cell's region under .cache/ (made on its first run in this
    checkout), and the program's sidecars of its mosaics where the
    traffic reads them (built by the program's own tool, as a user
    prepares a country)."""
    from port_bench.traffic.region import SEASONS, ensure_region, mosaic_path

    tr = run.cell.traffic
    t0 = time.perf_counter()
    run.data_root = ensure_region(os.path.join(cache, "regions"), tr["region"])
    if tr.get("sidecars"):
        from popcorn_tpu_torch.io.raster_cache import build_cache

        for season in SEASONS:
            for mod in ("S2", "S1"):
                build_cache(mosaic_path(run.data_root, mod, season))
    run.notes["data_s"] = time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from port_bench.harness import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: the cell needs {cell.chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present: "
              "no measurement", file=sys.stderr)
        return 2
    for k, v in cell.traffic.get("env", {}).items():
        os.environ[k] = str(v)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TQDM_DISABLE"] = "1"

    run = Run(cell, args.seed, "cuda")
    shutil.rmtree(run.scratch, ignore_errors=True)
    try:
        return _measure(run, args, spec, torch)
    finally:
        shutil.rmtree(run.scratch, ignore_errors=True)


def _measure(run, args, spec, torch) -> int:
    from port_bench.harness.trace import Tracer, load_kernel_table, reduce_trace

    cell = run.cell
    driver = spec.driver_module(cell.driver)
    prepare_data(run)
    driver.setup(run)
    run.sync()
    setup_s = time.perf_counter() - T_START

    tracer = None
    if args.trace:
        tracer = Tracer(cell.workload["trace"]["count"], os.path.join(run.tmp("trace"), "trace.json"))
    record = driver.window(run, args.seconds, tracer)
    on_card = run.device != "cpu"  # the CPU only in the harness's own tests
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    record.update(driver=cell.driver, device_name=name, config=cell.config, traffic=cell.traffic)
    if tracer is not None and tracer.export():
        record["trace"] = reduce_trace(tracer.out_path, load_kernel_table(spec.BENCH_DIR))

    driver.release(run)
    t_check = time.perf_counter()
    numbers = driver.check(run)
    run.notes["check_s"] = time.perf_counter() - t_check
    limits = spec.limits(cell.config_name)
    checks = {k: {"value": float(numbers[k]), "limit": limits[k]} for k in limits}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(record["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": memory_peak,
              "power_limit": card_power_limit() if on_card else "none"}
    result = {"correct": correct, "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics, "device": device}
    tr = record.get("trace")
    if args.trace and tr:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 3
    info = {k: v for k, v in numbers.items() if k not in checks}
    print(json.dumps({"notes": run.notes, "uncompared": info, "setup_s": setup_s,
                      "window_s": record["window_s"]}), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
