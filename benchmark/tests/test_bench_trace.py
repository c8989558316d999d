"""The reduction of the profiler's events to the traced run's record, on
made-up events: in the calls part a family's kernels are named by the
device operations that start inside its ranged calls, and its work is what
its counting rule read; in the device part busy time is a union over the
window between the synchronisations, a family's time is found by those
names (graph replays included), and the idle gaps are named by the CUDA
call the host was in."""

import pytest
import torch

from benchmark.harness import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
K1 = "void (anonymous namespace)::bvh_closest_kernel<false, 0, 16>(float*)"


class Ev:
    def __init__(self, name, dev, s, e, kind):
        self._v = (name, dev, int(s * 1e9), int(e * 1e9), kind)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def activity_type(self): return self._v[4]
    def linked_correlation_id(self): return 0


class FakeProfile:
    def __init__(self, events):
        results = type("K", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_the_calls_and_device_parts_make_the_record():
    tr = trace.Tracer({"bvh": None, "gather": None}, enabled=True)
    tr._prof = FakeProfile([
        Ev("bench.window", CPU, 10.0, 20.0, "user_annotation"),
        Ev("bench.k.bvh", CPU, 11.0, 12.0, "user_annotation"),
        Ev(K1, CUDA, 11.2, 11.7, "kernel"),
        Ev("Memcpy DtoH (Device -> Pageable)", CUDA, 11.8, 11.9, "gpu_memcpy"),
        Ev("void at::native::reduce_kernel<512>", CUDA, 12.1, 12.2, "kernel"),  # the count
        Ev("void other_kernel", CUDA, 13.0, 14.0, "kernel"),
    ])
    tr.calls["bvh"].append((torch.tensor(4096), 7))
    tr.record.update(tr._reduce_calls())
    fam = tr.record["families"]["bvh"]
    assert fam["kernel_names"] == [K1] and fam["work"] == [[4096.0, 7.0]]
    assert tr.record["families"]["gather"] == {"work": [], "kernel_names": []}

    tr._prof = FakeProfile([
        Ev("cudaDeviceSynchronize", CPU, 99.0, 100.0, "cuda_runtime"),
        Ev("cudaLaunchKernel", CPU, 100.5, 100.6, "cuda_runtime"),
        Ev(K1, CUDA, 101.0, 102.0, "kernel"),            # a graph replay's K1
        Ev("void at::native::mul_kernel", CUDA, 101.5, 103.0, "kernel"),
        Ev("cudaMemcpyAsync", CPU, 103.5, 106.5, "cuda_runtime"),
        Ev("void at::native::mul_kernel", CUDA, 107.0, 108.0, "kernel"),
        Ev("cudaDeviceSynchronize", CPU, 108.0, 110.0, "cuda_runtime"),
    ])
    tr.meta["frames"] = 2
    tr.record.update(tr._reduce_device(), host_window_s=10.0)
    rec = tr.result()
    assert rec["window_s"] == pytest.approx(10.0) and rec["frames"] == 2
    assert rec["busy_s"] == pytest.approx(3.0)          # 101-103 and 107-108
    assert rec["device_s"] == pytest.approx(3.5) and rec["device_ops"] == 3
    assert rec["families"]["bvh"]["device_s"] == pytest.approx(1.0)
    gaps = rec["breakdown"]["idle_gaps"]
    assert gaps[0] == ["cudaMemcpyAsync", pytest.approx(4.0)]
    assert [round(g[1], 6) for g in gaps] == [4.0, 2.0, 1.0]
    assert gaps[1][0] == "cudaDeviceSynchronize"   # 108-110, waiting on nothing
    assert gaps[2][0] == "cudaLaunchKernel"


def test_a_traced_run_needs_both_parts():
    tr = trace.Tracer({}, enabled=True)
    with pytest.raises(RuntimeError):
        tr.result()


def test_a_skew_of_the_clocks_under_half_the_guard_keeps_the_ranges():
    r = trace._Ranges([(1.0, 1.01, "bench.k.bvh"), (1.012, 1.013, "bench.count")])  # 2 ms apart
    half = trace.GUARD_S / 2
    assert r.label_at(1.0 - 0.4 * half, half) == "bench.k.bvh"     # device clock behind
    assert r.label_at(1.012 - 0.4 * half, half) == "bench.count"
    assert r.label_at(1.01 + 0.4 * half, half) == "bench.k.bvh"       # device clock ahead
    assert r.label_at(0.99, half) is None
