"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m benchmark.readings --workload <cell> --seeds 1-12 [--control-seeds 1-3]
        [--out PATH]

In one process, through the cell's family (``families/<family>.py``): its
``prepare`` once, then for each seed the program's first steps through the
window's own calls (``check_steps``, the check seed a run of that ``--seed``
would draw), the program freed; then, as a run does (``follow`` with what
the program drew at random), the reference in float32 for each seed, and
for the control seeds the control (the family's ``CONTROL`` precision) and
each of the family's ``FAULTS`` planted in the reference, each judged
against the float32 reference by the family's ``numbers``. Prints one JSON
object; ``--out`` also writes it there. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def _seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def collect(workload: str, seeds: list[int], control_seeds: list[int],
            device: str = "cuda") -> dict:
    import torch

    from benchmark import data, registry
    from benchmark.run import job_seed

    bench = registry.spec()
    entry = next(w for w in bench["workloads"] if w["name"] == workload)
    config = registry.config(entry["config"])
    traffic = registry.traffic(entry["traffic"])
    family = registry.family(registry.family_name(config))
    graph, _ = data.load_graph(config)
    t0 = time.perf_counter()
    prep = family.prepare(config, traffic, graph, device)
    out = {"workload": workload, "family": registry.family_name(config),
           "prepare_s": time.perf_counter() - t0, "sound": {}, "control": {},
           "faults": {f: {} for f in family.FAULTS}}
    if device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    every = sorted(set(seeds) | set(control_seeds))
    prog = {s: family.check_steps(prep, graph, job_seed(s, "check")) for s in every}
    del prep
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    inputs = family.reference_inputs(graph, config, traffic, device)
    t0 = time.perf_counter()
    for s in every:
        seed = job_seed(s, "check")
        ref = family.follow(inputs, config, seed, prog[s])
        if s in seeds:
            out["sound"][s] = family.numbers(prog[s], ref)
        if s in control_seeds:
            out["control"][s] = family.numbers(
                family.follow(inputs, config, seed, prog[s], precision=family.CONTROL), ref)
            for f in family.FAULTS:
                out["faults"][f][s] = family.numbers(
                    family.follow(inputs, config, seed, prog[s], fault=f), ref)
    out["reference_s"] = (time.perf_counter() - t0) / len(every)
    if out["sound"]:
        out["sound_max"] = {k: max(v[k] for v in out["sound"].values())
                            for k in family.NUMBERS}
    if out["control"]:
        out["control_min"] = {k: min(v[k] for v in out["control"].values())
                              for k in family.NUMBERS}
        out["faults_min"] = {f: {k: min(v[k] for v in out["faults"][f].values())
                                 for k in family.NUMBERS} for f in family.FAULTS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = collect(args.workload, _seeds(args.seeds), _seeds(args.control_seeds))
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
