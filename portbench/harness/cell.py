"""One run of one cell: set-up, warm-up, the window, the check, the result.

``run(...)`` does the work on a given device and returns the result's
fields; ``main`` adds what a run on the card needs around it (the look for
the card, the check that no JAX module was loaded, the printing). Tests
call ``run`` on the CPU.
"""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from . import graphs, registry, trace as tr, traffic
from .spans import Spans

# top-level module names no run may load: JAX, the JAX package and what
# only its scripts use
FORBIDDEN = ("jax", "jaxlib", "flax", "graphem_rapids_tpu", "experiments",
             "benchmarks", "bench", "networkx")


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _say(log, tag, **fields):
    print(json.dumps({tag: fields}, default=float), file=log, flush=True)


def power_limit():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run(root, bench, cell_name, seed, seconds, trace, device, t_start,
        control=False, log=sys.stdout):
    """The result's fields of one run (without the device check)."""
    cell = registry.cell(bench, cell_name)
    config = registry.config(root, bench, cell["config"])
    mix = registry.mix(root, bench, cell["traffic"])
    cuda = device == "cuda"
    marks = {"imports": time.perf_counter()}
    if cuda:
        torch.zeros(1, device=device)
    marks["context"] = time.perf_counter()

    family = registry.family(root, bench, config["graph"]["family"])
    adj, gstats = graphs.make_graph(config["graph"], seed, device, family)
    _sync(device)
    marks["graph"] = time.perf_counter()
    _say(log, "graph", seconds=marks["graph"] - marks["context"], **gstats)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    kind = registry.kind(root, bench, mix["kind"])
    spans = Spans(sync=bool(trace) and kind.sync_spans)
    calls = kind(mix, config, seed, device, spans)
    with spans.wrap(calls.setup_targets() if trace else []):
        calls.set_up(adj)
    _sync(device)
    marks["program"] = time.perf_counter()
    calls.warm_up()
    _sync(device)
    marks["warm_up"] = time.perf_counter()
    setup_s = marks["warm_up"] - t_start
    at = t_start
    split = {}
    for k, t in marks.items():
        split[k], at = t - at, t
    _say(log, "setup", seconds=setup_s, **split)
    before = calls.counters()

    trace_data = None
    if trace:
        with spans.wrap(calls.window_targets()):
            window, trace_data = tr.profile_window(
                lambda: traffic.closed_loop(calls.call,
                                            calls=int(mix["traced_calls"])),
                spans)
    else:
        window = traffic.closed_loop(calls.call, seconds=float(seconds))
    after = calls.counters()
    each = sorted(window["call_seconds"])
    _say(log, "counters", calls=window["calls"],
         call_seconds_min_median_max=[each[0], each[len(each) // 2],
                                      each[-1]],
         launches={k: after[k] - before[k] for k in after})

    steps = calls.program_check_steps()
    facts = calls.facts()
    _say(log, "facts", **facts)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = forbidden_modules()
    calls.release()
    t0 = time.perf_counter()
    numbers = calls.check(steps, control=control)
    _say(log, "check", seconds=time.perf_counter() - t0, **calls.notes)

    limits = config["limits"][mix["kind"]]
    compared = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    failed = sum(1 for c in compared.values() if not c["value"] <= c["limit"])
    ctl = {k[len("control."):]: v for k, v in numbers.items()
           if k.startswith("control.")}

    # what a metric's reader sees of the run
    record = SimpleNamespace(kind=mix["kind"], setup_s=setup_s,
                             window=window, peak_bytes=peak, spans=spans,
                             trace=trace_data, facts=facts)
    metrics = {}
    for m in registry.metrics(bench, cell_name, trace):
        value = registry.reader(root, bench, m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if cuda:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": window["calls"],
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_data is not None:
        dev["busy_s"] = tr.busy_seconds(trace_data)
        dev["window_s"] = trace_data.window_s
        result["breakdown"] = {
            "device_ops": tr.device_time_by_name(trace_data),
            "idle_gaps": tr.idle_by_span(trace_data)}
        if cuda:
            _say(log, "card", nvidia_smi=power_limit())
    if control:
        result["control"] = {
            k: {"value": v, "limit": limits[k],
                "fails": not v <= limits[k]} for k, v in ctl.items()
            if k in limits}
    result["compared"] = compared
    return result, loaded


def main(args, root, t_start):
    """Run the cell on the card; the exit code."""
    bench = registry.load_benchmark(root)
    chips = int(registry.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, loaded = run(root, bench, args.workload, args.seed,
                         args.seconds, args.trace, "cuda", t_start,
                         control=bool(args.control))
    loaded = sorted(set(loaded) | set(forbidden_modules()))
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
