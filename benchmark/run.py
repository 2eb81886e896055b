"""The benchmark of ``cuda_gcn_torch``: training jobs on one H100.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads/<name>.json``) names a configuration, whose model names
its family (``families/<family>.py``, families/__init__.py), and a traffic
mix. Everything that depends on the model is the family's; this file runs
any family. A run loads the configuration's graph (generated once a
checkout, benchmark/data.py), calls the family's ``prepare`` inside the span
``prepare_s``, and warms up on the cell's own shapes: the comparison's first
steps through the window's own calls (``check_steps``), then one whole job.
The window then runs training jobs back to back (``run_job``), their seeds
from the traffic's fixed pool of ``job_pool`` seeds in an order drawn from
``--seed`` (``window_seeds``), and closes at the first job end at or after
``--seconds``. With ``--trace 1`` the torch.profiler records the window's
first ``trace_jobs`` jobs (the traffic file's), and the run reports the
cell's per-layer metrics from that slice; with ``--trace 0`` the end-to-end
ones:

* ``setup_s``: the process's start to the window's start;
* ``epoch_ms``: the window's seconds over the epochs its jobs trained (the
  captures, eager first epochs, chunk reads and test evaluations count);
  ``sweep_epoch_ms`` is the same in a cell of short jobs, whose host-led
  window spreads wider and takes a bound of its own;
* ``peak_mem_gib``: ``torch.cuda.max_memory_allocated`` over the warm-up
  job and the window's first job, with the graph and X resident: what one
  job of the cell needs (the comparison's steps, before, are the
  benchmark's and do not count). The program's allocations grow with every
  further job (PERF.md), so a peak over the whole window would read how many
  jobs fit in it; ``memory_peak_bytes`` in ``device`` is that peak.

Once the window has closed and the program's state is freed, the family's
reference (``follow``) follows the same first steps with what the program
drew at random, and the family's ``numbers`` judge the program's readings
against it; each number and its limit (the cell file's ``limits``, which
name exactly the family's ``NUMBERS``) are the last lines on stderr and the
``checks`` key, last in the one JSON line on stdout. A run exits non-zero
and prints no result without a card, without the program, with JAX or the
JAX package loaded, or for a cell whose limits name other numbers.
"""

from __future__ import annotations

import argparse
import functools
import gc
import hashlib
import itertools
import json
import os
import random
import sys
import tempfile
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat and /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cuda_gcn_tpu")
SLICE_SPAN = "bench.slice"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def job_seed(seed, tag) -> int:
    """A job's seed from ``seed`` and ``tag``: 56 bits of a hash of both."""
    return int.from_bytes(hashlib.sha256(f"{seed}/{tag}".encode()).digest()[:7], "big")


def window_seeds(seed: int, pool: int):
    """The seeds of the window's jobs: every run draws from the same pool of
    ``pool`` job seeds, each pass over the pool in an order drawn from
    ``seed``, so that the seed changes the order of the work and not the
    work (an early-stopping job's length depends on its seed)."""
    seeds = [job_seed("pool", i) for i in range(pool)]
    for cycle in itertools.count():
        random.Random(job_seed(seed, f"order/{cycle}")).shuffle(seeds)
        yield from seeds


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


class Context:
    """What a per-layer metric's ``read`` sees of a traced run: the slice,
    whether its kernel records match the program's launch counts, each
    traced job's epochs, the family's shapes, and ``job_work``, a job's least
    work by part (the family's ``job_work`` at these shapes) as a function of
    its epochs, at the activations' type ``dtype``."""

    def __init__(self, slice_, records_ok, job_epochs, shapes, early_stopping, prepare_s,
                 job_work=None, dtype="float32"):
        self.slice, self.records_ok, self.job_epochs = slice_, records_ok, job_epochs
        self.shapes, self.early_stopping, self.prepare_s = shapes, early_stopping, prepare_s
        self.job_work, self.dtype = job_work, dtype

    def least_s(self, parts) -> float | None:
        """The least seconds of the traced jobs' work: each job's parts named
        in ``parts`` that its work gives, each part's least time summed; None
        where no job gives any of them."""
        if self.job_work is None:
            return None
        least, found = 0.0, False
        for e in self.job_epochs:
            work = self.job_work(e)
            found = found or any(p in work for p in parts)
            least += sum(work[p].least_s(self.dtype) for p in parts if p in work)
        return least if found else None


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_window(run_job, prep, seeds, seconds: float, trace_jobs: int, on_card: bool):
    """Jobs (``run_job(prep, seed)``) back to back until the first job end at
    or after ``seconds``; the profiler over the first ``trace_jobs`` of them.
    Returns (jobs as (ms, epochs, finite), window seconds, set-up seconds,
    the device's peak of allocated bytes by the end of the first job, the
    profiler or None, the program's launches over the traced slice)."""
    import torch
    from cuda_gcn_torch import kernels

    prof = span = None
    first_peak = 0
    launched: dict[str, int] = {}
    jobs: list[tuple[float, int, bool]] = []
    t_win = time.perf_counter()
    setup_s = _process_age_s()
    while True:
        if not jobs and trace_jobs:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            before = dict(kernels.launches)
            span = torch.profiler.record_function(SLICE_SPAN)
            span.__enter__()
        t_job = time.perf_counter()
        epochs, finite = run_job(prep, next(seeds))
        t_end = time.perf_counter()
        jobs.append(((t_end - t_job) * 1e3, epochs, finite))
        if len(jobs) == 1 and on_card:
            first_peak = torch.cuda.max_memory_allocated()
        if span is not None and len(jobs) == trace_jobs:
            if on_card:
                torch.cuda.synchronize()
            span.__exit__(None, None, None)
            prof.stop()
            span = None
            launched = {k: v - before.get(k, 0) for k, v in kernels.launches.items()}
        if t_end - t_win >= seconds and span is None:
            return jobs, t_end - t_win, setup_s, first_peak, prof, launched


def traced_metrics(bench, cell: str, prof, launched, job_epochs, shapes, early_stopping,
                   prepare_s, job_work, dtype):
    """(the cell's per-layer metrics, busy seconds, traced seconds, breakdown)
    from the profiler's trace of the slice."""
    from benchmark import registry, trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        sl = trace.read(path, SLICE_SPAN)
    differ = trace.launches_match(sl, launched)
    for line in differ:
        log(f"trace records differ from the launch counts: {line}")
    ctx = Context(sl, not differ, job_epochs, shapes, early_stopping, prepare_s,
                  job_work=job_work, dtype=dtype)
    metrics = {}
    for m in registry.cell_metrics(bench, cell, "per_layer"):
        value = registry.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = {"device_ops": sl.device_ops(), "idle_gaps": sl.idle_gaps()}
    log(f"traced {len(job_epochs)} jobs: busy {sl.busy_s():.4f} of {sl.window_s:.4f} s")
    return metrics, sl.busy_s(), sl.window_s, breakdown


def main(argv=None, device: str = "cuda") -> int:
    """A run on ``device``; the tests pass 'cpu', which skips the look for a
    card and runs the program's plain versions."""
    args = parse_args(argv)
    from benchmark import compare, data, program, registry

    bench = registry.spec()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = registry.workload(args.workload)
    config = registry.config(entry["config"])
    traffic = registry.traffic(entry["traffic"])
    family_name = registry.family_name(config)
    family = registry.family(family_name)
    limits = cell["limits"]
    if set(limits) != set(family.NUMBERS):
        log(f"cell {args.workload!r}: its limits name {', '.join(sorted(limits))}; "
            f"family {family_name!r} compares {', '.join(family.NUMBERS)}")
        return 2

    import torch

    torch.set_num_threads(1)  # one process, one host thread of ATen: a steadier host
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < entry["chips"]):
        log(f"this cell needs {entry['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    try:
        import cuda_gcn_torch  # noqa: F401
    except ImportError as e:
        log(f"the program under test cannot be imported: {e}")
        return 2
    program.use_cache_dirs(os.path.join(registry.ROOT, "build"))
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    phases = {"start": _process_age_s()}
    t0 = time.perf_counter()
    graph, generated = data.load_graph(config)
    phases["graph"] = time.perf_counter() - t0
    log(f"graph {config['name']}: {graph['num_nodes']} nodes, {len(graph['indices'])} nnz"
        + (" (generated now)" if generated else " (cached)"))
    t0 = time.perf_counter()
    prep = family.prepare(config, traffic, graph, device)
    if on_card:
        torch.cuda.synchronize()
    prepare_s = phases["prepare"] = time.perf_counter() - t0
    log(f"prepare_s {prepare_s:.3f} (family {family_name})")

    # warm-up on the cell's own shapes: the comparison's steps, then one job
    check_seed = job_seed(args.seed, "check")
    t0 = time.perf_counter()
    readings = family.check_steps(prep, graph, check_seed)
    phases["check"] = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    family.run_job(prep, job_seed(args.seed, "warm"))
    if on_card:
        torch.cuda.synchronize()
    phases["warm"] = time.perf_counter() - t0
    log("set-up phases, s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    trace_jobs = int(traffic["trace_jobs"]) if args.trace else 0
    jobs, window_s, setup_s, first_peak, prof, launched = run_window(
        family.run_job, prep, window_seeds(args.seed, int(traffic["job_pool"])), args.seconds,
        trace_jobs, on_card)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        log(f"device memory: peak allocated {first_peak / 2**30:.3f} GiB by the first job's "
            f"end, {peak / 2**30:.3f} GiB and {torch.cuda.memory_reserved() / 2**30:.3f} GiB "
            f"reserved after {len(jobs)} jobs")
    epochs_total = sum(e for _, e, _ in jobs)
    failed = sum(1 for *_, ok in jobs if not ok)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak}
    log(f"window {window_s:.3f} s: {len(jobs)} jobs, {epochs_total} epochs, {failed} failed")

    breakdown = None
    if args.trace:
        shapes = family.shapes(prep, graph, config, traffic)
        early_stopping = bool(traffic.get("early_stopping", 0))
        job_work = functools.partial(family.job_work, shapes, early_stopping=early_stopping)
        result_metrics, busy_s, traced_s, breakdown = traced_metrics(
            bench, args.workload, prof, launched, [e for _, e, _ in jobs[:trace_jobs]],
            shapes, early_stopping, prepare_s, job_work, config["compute_dtype"])
        del prof
        dev.update(busy_s=busy_s, window_s=traced_s)
    else:
        epoch_ms = window_s * 1e3 / max(epochs_total, 1)
        e2e = {"setup_s": setup_s, "epoch_ms": epoch_ms, "sweep_epoch_ms": epoch_ms,
               "peak_mem_gib": first_peak / 2**30}
        result_metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in registry.cell_metrics(bench, args.workload, "end_to_end")}

    # the reference, once the window has closed and the program's state is freed
    del prep
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    inputs = family.reference_inputs(graph, config, traffic, device)
    ref = family.follow(inputs, config, check_seed, readings)
    del inputs
    values = family.numbers(readings, ref)
    correct = compare.judge(values, limits) and failed == 0
    log(f"reference {time.perf_counter() - t_ref:.2f} s")

    bad = forbidden_loaded()
    if bad:
        log(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}")
        return 3
    checks = {k: {"value": values[k] if values[k] < float("inf") else "inf", "limit": limits[k]}
              for k in family.NUMBERS}
    checks["failed_jobs"] = {"value": failed, "limit": 0}
    for k, v in checks.items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    result = {"correct": bool(correct), "attempted": len(jobs), "failed": failed,
              "metrics": result_metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
