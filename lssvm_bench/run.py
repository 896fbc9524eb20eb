"""Run one cell of the benchmark (``BENCHMARK.json``) and print its result.

    python3 -m lssvm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's data from the seed, builds and warms the program
(``plssvm_sparse_fp22_tpu_torch``) through its public API, measures its
traffic for ``--seconds``, checks the outputs against the float64 reference
and prints one JSON line last.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled window.

Refuses to run (exit 2, no result) without as many CUDA devices as the cell
asks for.  ``--cpu`` (tests only) runs on the CPU with the program's
``torch`` backend; ``--control tf32`` puts the reference, computed at TF32,
in the program's place (the control that has to come out not correct)."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
#: threads of the process's CPU operations
HOST_THREADS = 1
#: seconds of a traced window that the profiler records: a learn cell's
#: 51 s of events (some 1,250 learns of the ijcnn1 grid) ended the process
#: in the profiler (exit 134, H100); 30 s of them did not
TRACE_SECONDS = 20.0
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "plssvm_sparse_fp22_tpu")


def caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own extension build is ``plssvm_sparse_fp22_tpu_torch/_build``),
    and one host thread for the process's CPU operations: a pool of threads
    that spin between the host's small operations made runs of one seed
    differ by 10 % from process to process, one thread by 2 % (H100 host,
    8 cores)."""
    root = HERE / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(root / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(HOST_THREADS)


def spec(workload: str, bench_path: Path = CHECKOUT / "BENCHMARK.json") -> dict:
    """The cell, its configuration, traffic mix, metrics and limits, each
    found by name beside the ``BENCHMARK.json`` read."""
    bench = json.loads(bench_path.read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload '{workload}' in {bench_path}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    base = bench_path.parent

    def mine(metric):
        return metric.get("workloads") is None or workload in metric["workloads"]

    pkg = base / HERE.name
    return {
        "cell": cell,
        "root": pkg,
        "config": json.loads((base / cfg_entry["file"]).read_text()),
        "traffic": json.loads((pkg / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((pkg / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(root: Path, name: str):
    """The metric's reader: ``metrics/<name>.py``, else the reader of its
    stem, ``metrics/<name up to the first dot>.py``, which serves every
    metric of that quantity."""
    import importlib.util

    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(f"lssvm_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def refuse_forbidden() -> bool:
    """Whether the process holds a module of :data:`FORBIDDEN` (whole
    top-level names: the port's name begins with the JAX package's), named
    on standard error."""
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
    if found:
        print(f"lssvm_bench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
    return bool(found)


def smi(fields: str):
    """The first card's ``nvidia-smi`` readings of ``fields``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return [v.strip() for v in out.splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def power_limit_w():
    try:
        return float(smi("power.limit")[0])
    except (TypeError, ValueError):
        return None


def spread_of(call_s) -> str:
    """The window's calls at a glance, for a look at where a slow run lost
    its time: per half of the window the median call, and the process's
    CPU seconds (a pool of host threads that spins shows as more CPU time
    than wall time)."""
    import resource
    import statistics

    done = [t for t in call_s if t is not None]
    half = len(done) // 2
    use = resource.getrusage(resource.RUSAGE_SELF)
    meds = [statistics.median(h) if h else None for h in (done[:half], done[half:])]
    return (f"calls={len(done)} median_first_half={meds[0]!r} median_second_half={meds[1]!r} "
            f"max={max(done, default=None)!r} cpu_user={use.ru_utime!r} "
            f"cpu_sys={use.ru_stime!r}")


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m lssvm_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--bench", type=Path, default=CHECKOUT / "BENCHMARK.json",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    caches()
    import torch

    torch.set_num_threads(HOST_THREADS)
    s = spec(args.workload, args.bench)
    chips = int(s["cell"]["chips"])
    if not args.cpu and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"lssvm_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from . import checks, data, loop, trace

    result, check_values = measure(args, s, torch, data, loop, trace, checks)
    for row in check_values.pop("details", []):
        print("sample " + " ".join(f"{k}={v!r}" for k, v in row.items()), file=sys.stderr)
    if refuse_forbidden():
        return 1
    # the cell's limits name the numbers compared; one it names that the
    # run did not read counts as infinitely far off
    compared = {k: float(check_values.get(k, math.inf)) for k in s["limits"]}
    result["correct"] = bool(result["correct"]) and all(
        v <= s["limits"][k] for k, v in compared.items())
    # a reading that is not finite is printed as the largest finite float
    result["checks"] = {k: {"value": v if math.isfinite(v) else sys.float_info.max,
                            "limit": s["limits"][k]} for k, v in compared.items()}
    for k, v in compared.items():
        print(f"check {k} {v!r} limit {s['limits'][k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def measure(args, s, torch, data, loop, trace, checks):
    cfg, mix = s["config"], s["traffic"]
    chips = int(s["cell"]["chips"])
    dev = torch.device("cpu" if args.cpu else "cuda:0")
    ds = data.make(cfg, args.seed, dev, test_sets=int(mix.get("test_sets", 0)))
    program = program_factory(args, cfg, ds, chips, dev)
    traffic = loop.KINDS[mix["kind"]](mix, cfg, ds, program, args.seed)
    traffic.warm()
    if dev.type == "cuda":
        for d in range(chips):
            torch.cuda.synchronize(d)
    prof = tr = None
    timings = None
    traffic.learn_infos.clear()
    if args.trace:
        from plssvm_sparse_fp22_tpu_torch.utils.timing import Timings

        timings = Timings
        prof = trace.profiler()
        prof.start()
    setup_s = time.perf_counter() - T0
    if args.trace:
        # the profiler sees the window's first TRACE_SECONDS; the rest runs
        # with the spans alone
        with trace.window():
            window_s, call_s, failed = loop.window(
                traffic, min(args.seconds, TRACE_SECONDS), timings)
            if dev.type == "cuda":
                for d in range(chips):
                    torch.cuda.synchronize(d)
        prof.stop()
        tr = trace.reduce(prof)
        del prof
        if args.seconds > window_s:
            rest = loop.window(traffic, args.seconds - window_s, timings, first=len(call_s))
            window_s, call_s, failed = (window_s + rest[0], call_s + rest[1],
                                        failed + rest[2])
    else:
        window_s, call_s, failed = loop.window(traffic, args.seconds)
    peak = (max(torch.cuda.max_memory_allocated(d) for d in range(chips))
            if dev.type == "cuda" else 0)
    print(f"window {spread_of(call_s)} threads={torch.get_num_threads()} "
          f"cores={len(os.sched_getaffinity(0))} "
          f"card={smi('clocks.sm,clocks.mem,temperature.gpu,power.draw') if dev.type == 'cuda' else None}",
          file=sys.stderr)
    ctx = {"config": cfg, "traffic": mix, "chips": chips, "window_s": window_s,
           "call_s": [t for t in call_s if t is not None], "setup_s": setup_s,
           "points_per_call": int(cfg.get("test_rows", 0)), "learns": traffic.learn_infos,
           "trace": tr, "rows": ds.rows, "features": ds.features}
    metrics = {}
    for m in (s["per_layer"] if args.trace else s["end_to_end"]):
        value = reader(s["root"], m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    answers = traffic.answers()
    model = getattr(traffic, "trained", None)
    if hasattr(traffic, "release"):
        traffic.release()
    del traffic, program
    release(torch, dev)
    if isinstance(model, dict):
        values = checks.learns([model], ds, cfg, dev)
        values.update(checks.predictions(answers, (model["alphas"], model["bias"],
                                                   model["gamma"]), ds, cfg, dev))
    else:
        spread = ([torch.device("cuda", d) for d in range(chips)] if dev.type == "cuda"
                  else None)
        values = checks.learns(answers, ds, cfg, dev, spread=spread)
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": chips, "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device["power_limit_w"] = power_limit_w()
    result = {"correct": failed == 0 and bool(answers), "attempted": len(call_s),
              "failed": failed, "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = sum(tr.busy_s.values()) / chips
        device["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    return result, values


def program_factory(args, cfg, ds, chips, dev):
    """``(cost, gamma) -> estimator``: a fresh ``CSVM`` of the program, or
    the control in its place."""
    if args.control:
        from .reference.control import ControlSVM

        spread = [f"cuda:{d}" for d in range(chips)] if dev.type == "cuda" else None

        def control(cost, gamma):
            return ControlSVM(ds, kernel=cfg["kernel"], gamma=gamma, cost=cost,
                              epsilon=float(cfg["epsilon"]), max_iter=cfg.get("max_iter"),
                              device=dev, precision=args.control, spread=spread)
        return control

    import numpy as np
    import plssvm_sparse_fp22_tpu_torch as port
    from plssvm_sparse_fp22_tpu_torch.io.libsvm import ParsedData

    parsed = ParsedData(csr=ds.csr, values=ds.y, _dense=ds.dense)
    backend = port.BackendType.torch if args.cpu else port.BackendType.from_string(
        cfg.get("backend", "cuda"))
    target = port.TargetPlatform.cpu if args.cpu else port.TargetPlatform.gpu_nvidia
    dtype = {"float32": np.float32, "float64": np.float64}[cfg["dtype"]]

    def make(cost, gamma):
        p = port.Parameter(kernel=port.KernelType.from_string(cfg["kernel"]), gamma=gamma,
                           cost=cost, epsilon=float(cfg["epsilon"]), print_info=False,
                           backend=backend, target=target, dtype=dtype,
                           max_iter=cfg.get("max_iter"), devices=chips)
        p.data, p.values = parsed, ds.y
        return port.make_csvm(p)
    return make


def release(torch, dev) -> None:
    """Free the program's state before the reference runs: its kept CG
    layouts and graphs, then the allocator's cache."""
    solver = sys.modules.get("plssvm_sparse_fp22_tpu_torch.solver.cg")
    if solver is not None:
        solver.clear_graphs()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
