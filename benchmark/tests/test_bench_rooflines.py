"""The rooflines' counting rules on fixed inputs."""

import pytest
import torch

from benchmark.harness import peaks, spec
from conftest import REPO

FAM = spec.load_families(REPO)


def planes(n, live):
    p = [torch.zeros(n) for _ in range(8)]
    p[6] = torch.zeros(n)
    p[7] = torch.where(torch.arange(n) < live, 1.0, -1.0)  # tmax > tmin on `live` lanes
    return p


def test_bvh_closest_counts_box_tests_of_live_rays_and_one_row_test_a_hit():
    n = 10
    i32 = torch.int32
    tabs = [torch.zeros(64, 24), torch.zeros(8, dtype=i32), torch.zeros(8, dtype=i32),
            torch.zeros(8, 8), torch.zeros(64, dtype=torch.uint8), torch.zeros(32, 8)]
    t = torch.zeros(n)
    idx = torch.tensor([0, 1, -1, 3, -1, -1, -1, -1, -1, -1], dtype=torch.int32)
    nb, fl = FAM["bvh"].CALLS["bvh_closest"]((*planes(n, 6), *tabs), {}, (t, idx))
    assert nb == 8 * n * 4 + (64 * 24 * 4 + 8 * 4 + 8 * 4 + 64 * 4 + 64 + 32 * 8 * 4) + n * 4 * 2
    assert int(fl) == 6 * 8 * 22 + 3 * (18 + 55)
    occ = torch.tensor([1, 0, 0, 1, 1, 0, 0, 0, 0, 0], dtype=torch.int32)
    _, fl = FAM["bvh"].CALLS["bvh_anyhit"]((*planes(n, 6), *tabs), {}, occ)
    assert int(fl) == 6 * 8 * 22 + 3 * 50


def test_sweep_counts_only_live_rows_and_their_boxes():
    n = 4
    tri = torch.zeros(40 * 64, 24)
    boxes = torch.zeros(40 + 2, 8)   # 40 chunk boxes, 2 super-boxes
    idx = torch.tensor([5, -1, -1, -1], dtype=torch.int32)
    nb, fl = FAM["sweep"].CALLS["sweep_closest"]((*planes(n, 2), tri, boxes), {"rows": 2100},
                                                 (torch.zeros(n), idx))
    live_chunks = 33   # ceil(2100 / 64), past 32: its 2 super-boxes count
    assert nb == 8 * n * 4 + 2100 * 24 * 4 + live_chunks * 32 + 2 * 32 + n * 8
    assert int(fl) == 2 * 2 * 22 + 1 * (18 + 55)
    small = torch.zeros(64, 24)
    nb, fl = FAM["sweep"].CALLS["sweep_anyhit"]((*planes(n, 3), small, torch.zeros(1, 8)),
                                                {"rows": 4}, torch.tensor([1, 1, 0, 0]))
    assert nb == 8 * n * 4 + 4 * 24 * 4 + 32 + n * 8
    assert int(fl) == 3 * 1 * 22 + 2 * 50


def test_gather_counts_the_selected_columns_once():
    table = torch.zeros(100, 26)
    idx = torch.zeros(1000, dtype=torch.int32)
    out = torch.zeros(3, 1000)
    nb, fl = FAM["gather"].CALLS["gather_planes"]((table, idx, (0, 5, 7)), {}, out)
    assert (nb, fl) == (100 * 3 * 4 + 1000 * 4 + 3000 * 4, 0)
    nb, _ = FAM["gather"].CALLS["gather_planes"]((table, idx), {}, torch.zeros(26, 1000))
    assert nb == 100 * 26 * 4 + 1000 * 4 + 26000 * 4


def test_count_less_counts_a_binary_search_a_query():
    cdf, q, out = torch.zeros(65), torch.zeros(1000), torch.zeros(1000, dtype=torch.int32)
    nb, fl = FAM["count_less"].CALLS["count_less"]((cdf, q), {}, out)
    assert (nb, fl) == (65 * 4 + 1000 * 4 + 1000 * 4, 1000 * 7)
    rows = torch.zeros(1000, dtype=torch.int32)
    nb, fl = FAM["count_less"].CALLS["count_less"]((torch.zeros(64, 129), q), {"rows": rows}, out)
    assert (nb, fl) == (64 * 129 * 4 + 4000 + 4000 + 4000, 1000 * 8)


def test_the_bound_holds_whatever_the_l2_cache_holds():
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    small = 10 << 20        # fits the cache: its rate alone
    assert peaks.bound_s(small, 0) == pytest.approx(small / peaks.L2_BYTES_PER_S)
    big = 10 * peaks.HBM_BYTES_PER_S   # 10 s at the HBM rate, less two caches' worth
    assert peaks.bound_s(big, 0) == pytest.approx((big - 2 * peaks.L2_BYTES)
                                                  / peaks.HBM_BYTES_PER_S)
    assert peaks.L2_BYTES_PER_S > peaks.HBM_BYTES_PER_S


def test_a_share_is_the_work_of_the_samples_traced_over_their_device_time():
    share = spec.load_module(REPO, "metrics", "traversal_roofline.offline").read
    b = 1e-6 * peaks.L2_BYTES_PER_S            # 1 us at the L2 rate, within the cache
    fam = {"work": [[b, 0.0], [b, 0.0]], "device_s": 0.0, "kernel_names": ["k"]}
    trace = {"calls_samples": 1, "samples": 4,
             "families": {"bvh": {**fam, "device_s": 3.2e-5}, "gather": {**fam, "device_s": 1.0}}}
    # 2 us of bound a sample, 4 samples, 32 us of device time
    assert share({"kind": "offline", "trace": trace}) == pytest.approx(25.0)
    trace["families"]["bvh"]["device_s"] = 0.0
    assert share({"kind": "offline", "trace": trace}) is None
