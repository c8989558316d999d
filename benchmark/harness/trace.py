"""The traced run: two torch.profiler windows and the record read from them.

A traced run profiles two parts of its window, one after the other:

``calls`` (CPU and CUDA activities; a render at the set-up's spp, or 2 of
  the viewer's frames): ``Tracer`` wraps the wrapper functions of every
  kernel family of ``benchmark/rooflines/`` where the program's modules
  reach them. Each call made in this part, outside a CUDA graph capture,
  runs between two synchronisations and 1 ms of quiet host time, inside a
  profiler range ``bench.k.<family>``, so that every device operation it
  launches starts inside the range's host interval, give or take a skew of
  the two clocks under half a millisecond. The family's counting rule reads
  the call's work (bytes, float operations) from its arguments and outputs
  (device counts, read once the part has closed). This part gives each
  family's work, call by call, and the names of the kernels the family
  launched (every kernel but PyTorch's own, ``at::``). It times nothing.
``device`` (CUDA activity alone, no host operation recorded, the wrappers
  passed through; one image, or 30 of the viewer's frames):
  the timed path as it runs, graph replays included. The part's window runs
  from the end of a synchronise at its start to the end of one at its end
  (the profiler records both CUDA calls on the host's clock). This part
  gives the device's busy time (the union of its operations' intervals),
  its operations and device time, each family's device time by the kernel
  names of the first part, and the breakdown: the costliest device
  operations and the longest idle gaps, named by the CUDA call the host was
  in (or "host, between CUDA calls").

A roofline share is then a family's work per sample, from the first part,
over its device time per sample in the second (metrics/_roofline.py).
Once a profiler has started in a process, CUPTI slows every launch, also
after it has stopped, so the host times that the per-layer metrics read
(metrics/device_idle.*, overhead_ms.offline, pump_ms.interactive) come from
images or frames made before the first part; the first start takes
seconds, inside the traced run's window.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
FAMILY_PREFIX = "bench.k."
SYNC = "cudaDeviceSynchronize"   # the host call whose ends bound the device part
# quiet host time around each ranged call: no device operation starts within
# it, so that an operation is told to its range under a skew of the device's
# clock against the host's of up to half of it
GUARD_S = 1e-3


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] in which no interval runs."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def short_name(name: str) -> str:
    """A kernel's name without its argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def is_pytorch_kernel(name: str) -> bool:
    return name.startswith(("at::", "void at::", "void at_cuda_detail::", "void cub"))


def _kind(ev):
    """The event's activity type where this torch's profiler gives it;
    elsewhere the host side's from its flags and name, None on the device."""
    f = getattr(ev, "activity_type", None)
    if f is not None:
        return f()
    if ev.device_type() != torch.autograd.DeviceType.CPU:
        return None
    if getattr(ev, "is_user_annotation", lambda: ev.name().startswith("bench."))():
        return "user_annotation"
    if ev.linked_correlation_id() > 0:
        return "cuda_runtime"
    return "cpu_op"


def _events(prof):
    """(device, host, kinds) of a stopped profile, times in seconds from its
    first event: device = [(start, end, name, kind)] of its device
    operations, host = [(start, end, name)] of every host event."""
    events = prof.profiler.kineto_results.events()
    cpu_t = torch.autograd.DeviceType.CPU
    annotations = {ev.name() for ev in events
                   if ev.device_type() == cpu_t and _kind(ev) == "user_annotation"}
    base = min((ev.start_ns() for ev in events), default=0)  # exact in int, then seconds
    device, host, kinds = [], [], defaultdict(int)
    for ev in events:
        kind, name = _kind(ev), ev.name()
        s, e = (ev.start_ns() - base) * 1e-9, (ev.end_ns() - base) * 1e-9
        if ev.device_type() != cpu_t:
            if kind is None:
                kind = "gpu_user_annotation" if name in annotations else (
                    "gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            if kind in DEVICE_ACTIVITIES:
                device.append((s, e, name, kind))
        else:
            host.append((s, e, name))
        kinds[kind] += 1
    return device, host, dict(kinds)


class _Ranges:
    """Sorted, disjoint host intervals with a label each (the bench ranges,
    which run one after another on one thread)."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _, _ in spans]
        self.spans = spans

    def label_at(self, t: float, slack: float = 0.0):
        """The range holding time t, each range widened by ``slack`` on
        both sides."""
        i = bisect.bisect_right(self.starts, t + slack) - 1
        if i >= 0:
            s, e, label = self.spans[i]
            if t <= e + slack:
                return label
        return None


class Tracer:
    def __init__(self, families: dict, enabled: bool):
        self.families = families
        self.enabled = enabled
        self.active = False     # the calls part is open: wrappers range and count
        self.part = None
        self.calls = defaultdict(list)  # family -> [(bytes, flops)] of ranged calls
        self.meta = {}          # what each part traced (samples or frames)
        self.record = {}
        self._prof = None

    # -- wrapping -------------------------------------------------------------
    def install(self) -> None:
        """Wrap each family's wrapper functions in every loaded module of
        the program that holds them (the defining module included, so that
        calls through its own globals are wrapped too)."""
        if not self.enabled:
            return
        for fam, mod in self.families.items():
            __import__(mod.MODULE)
            home = sys.modules[mod.MODULE]
            top = mod.MODULE.split(".")[0]
            for fn_name, work in mod.CALLS.items():
                orig = getattr(home, fn_name)
                wrapped = self._wrap(fam, orig, work)
                for m in list(sys.modules.values()):
                    if getattr(m, "__name__", "").split(".")[0] == top \
                            and getattr(m, fn_name, None) is orig:
                        setattr(m, fn_name, wrapped)

    def _wrap(self, fam, fn, work):
        tag = FAMILY_PREFIX + fam
        rf = torch.autograd.profiler.record_function
        tracer = self

        def wrapped(*args, **kwargs):
            if not tracer.active or torch.cuda.is_current_stream_capturing():
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            time.sleep(GUARD_S)
            with rf(tag):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            time.sleep(GUARD_S)
            tracer.calls[fam].append(work(args, kwargs, out))
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    # -- the parts --------------------------------------------------------------
    def start(self, part: str) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.part = part
        if part == "calls":
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.start()
            self._window = torch.autograd.profiler.record_function(WINDOW)
            self._window.__enter__()
            self.active = True
        else:
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        host_s = time.perf_counter() - self.t0
        if self.part == "calls":
            self.active = False
            self._window.__exit__(None, None, None)
            self._prof.stop()
            self.record.update(self._reduce_calls())
        else:
            self._prof.stop()
            self.record.update(self._reduce_device(), host_window_s=host_s)
        self._prof = None
        self.part = None

    def result(self) -> dict:
        """The traced run's record, once both parts have closed."""
        if "busy_s" not in self.record or "families" not in self.record:
            raise RuntimeError("a traced run must close both of its profiled parts")
        return {**self.meta, **self.record}

    # -- reduction ------------------------------------------------------------
    def _reduce_calls(self) -> dict:
        device, host, kinds = _events(self._prof)
        win = next(((s, e) for s, e, n in host if n == WINDOW), None)
        if win is None:
            raise RuntimeError("the calls part left no record of its window")
        ranges = _Ranges([(s, e, n) for s, e, n in host if n.startswith(FAMILY_PREFIX)])
        names = defaultdict(set)
        for s, e, name, kind in device:
            label = ranges.label_at(s, GUARD_S / 2)
            if label is not None and kind == "kernel" and not is_pytorch_kernel(name):
                names[label[len(FAMILY_PREFIX):]].add(name)
        families = {f: {"work": [[float(b), float(x)] for b, x in self.calls.get(f, [])],
                        "kernel_names": sorted(names.get(f, ()))}
                    for f in self.families}
        self.calls.clear()
        return {"families": families, "calls_window_s": win[1] - win[0], "calls_kinds": kinds}

    def _reduce_device(self) -> dict:
        device, host, kinds = _events(self._prof)
        syncs = sorted(e for _, e, n in host if n == SYNC)
        if len(syncs) < 2:
            names = sorted({n for _, _, n in host})[:20]
            raise RuntimeError(f"the device part's bounding synchronisations are missing: "
                               f"{kinds}, host calls {names}")
        lo, hi = syncs[0], syncs[-1]
        inside = [(max(s, lo), min(e, hi), n) for s, e, n, _ in device if e > lo and s < hi]
        if not inside:
            raise RuntimeError(f"the profiler recorded no device operation: {kinds}")
        fam_of = {}
        for f, rec in self.record.get("families", {}).items():
            for n in rec["kernel_names"]:
                fam_of[n] = f
        fam_s = defaultdict(float)
        by_name = defaultdict(float)
        for s, e, n in inside:
            by_name[short_name(n)] += e - s
            if n in fam_of:
                fam_s[fam_of[n]] += e - s
        for f, rec in self.record.get("families", {}).items():
            rec["device_s"] = fam_s.get(f, 0.0)
        intervals = [(s, e) for s, e, _ in inside]
        host.sort()
        starts = [s for s, _, _ in host]
        gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])[:10]
        return {
            "window_s": hi - lo,
            "busy_s": union_s(intervals, lo, hi),
            "device_s": sum(e - s for s, e, _ in inside),
            "device_ops": len(inside),
            "device_kinds": kinds,
            "breakdown": {
                "device_ops": [[n, v] for n, v in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
                "idle_gaps": [[_host_doing(host, starts, gs, ge), ge - gs] for gs, ge in gaps],
            },
        }


def _host_doing(spans, starts, gs: float, ge: float) -> str:
    """The host's CUDA call that overlaps the gap [gs, ge] the most, or
    "host, between CUDA calls" where none does."""
    best, best_overlap = "host, between CUDA calls", 0.0
    last = bisect.bisect_left(starts, ge) - 1
    for j in range(last, max(last - 4000, -1), -1):
        s, e, name = spans[j]
        overlap = min(e, ge) - max(s, gs)
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return best
