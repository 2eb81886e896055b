"""Reading a ``torch.profiler`` trace of a slice of jobs: the device's busy
time as the union of its operations' intervals, kernel time by name, the
idle gaps by what the host was doing, and the host's blocking CUDA calls.

The trace is the Chrome trace that ``export_chrome_trace`` writes. Device
operations are the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the host's are ``cpu_op``, ``user_annotation`` and
``cuda_runtime``/``cuda_driver``.
"""

from __future__ import annotations

import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# CUDA runtime calls after which the host waits for the device
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                  "cudaMemcpy")
# the program's launch counters (kernels.launches) and the device kernels
# that each counted launch runs exactly once
LAUNCH_KERNELS = {"bsr_tile": ("bsr_mma_kernel", "bsr_tile_kernel"),
                  "csr_spmm": ("csr_spmm_kernel",), "ell_spmm": ("ell_spmm_kernel",)}


def base_name(name: str) -> str:
    """A kernel's name without namespaces, template arguments, return type or
    arguments: 'void spmm::reduce_partials_kernel<float>(...)' ->
    'reduce_partials_kernel'."""
    return short_name(name).split("<")[0].strip().rsplit("::", 1)[-1]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


@dataclasses.dataclass
class Slice:
    """The events of the traced window [start, end] (µs, the trace's clock)."""

    start: float
    end: float
    device: list[tuple[str, float, float]]   # (name, start, end) of device operations
    host: list[tuple[str, float, float, int]]  # (name, start, end, thread) of host events
    kernels: list[tuple[str, float, float]]  # the device events of category kernel

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) * 1e-6

    def kernel_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.kernels if base_name(n) == name)

    def blocking_calls(self) -> int:
        return sum(1 for n, _, _, _ in self.host if n in BLOCKING_CALLS)

    def device_ops(self, top: int = 10) -> list[list]:
        total: dict[str, float] = collections.defaultdict(float)
        for n, s, e in self.device:
            total[short_name(n)[:120]] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle seconds summed by the innermost host event that spans each
        gap's middle ('none' where the host was in no traced event)."""
        total: dict[str, float] = collections.defaultdict(float)
        prev = self.start
        gaps = []
        for s, e in self.busy_intervals() + [(self.end, self.end)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        host = sorted(self.host, key=lambda t: t[1])
        active: list[tuple[str, float, float, int]] = []
        i = 0
        for s, e in gaps:  # in order, so their middles increase
            mid = 0.5 * (s + e)
            while i < len(host) and host[i][1] <= mid:
                active.append(host[i])
                i += 1
            active = [t for t in active if t[2] >= mid]
            inner = min(active, key=lambda t: t[2] - t[1], default=None)
            total[inner[0] if inner else "none"] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def read(path: str, span: str) -> Slice:
    """The slice of the Chrome trace at ``path`` inside the host annotation
    named ``span``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("name") == span and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"no annotation {span!r} in the trace")
    start = float(marks[0]["ts"])
    end = start + float(marks[0]["dur"])
    device, host, kernels = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = (e["name"], s, s + float(e["dur"]))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            device.append(t)
            if cat == "kernel":
                kernels.append(t)
        elif cat in HOST_CATS and e["name"] != span:
            host.append((*t, e.get("tid", 0)))
    inside = lambda t: t[2] > start and t[1] < end  # noqa: E731
    return Slice(start=start, end=end, device=[t for t in device if inside(t)],
                 host=[t for t in host if inside(t)], kernels=[t for t in kernels if inside(t)])


def launches_match(sl: Slice, launched: dict[str, int]) -> list[str]:
    """Where the trace's kernel records differ from the program's launch
    counts over the slice: one line each, empty when they agree."""
    out = []
    for key, names in LAUNCH_KERNELS.items():
        want = launched.get(key, 0)
        got = sum(sl.kernel_count(n) for n in names)
        if got != want:
            out.append(f"{key}: {want} launches counted by the program, {got} kernel "
                       f"records of {'/'.join(names)} in the trace")
    return out
