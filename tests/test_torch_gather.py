"""Port parity: plane gathers (K3) and CDF counts (K4) on the CPU.

The port's wrappers run their plain versions for CPU tensors; these are
held bit for bit against the reference's Pallas kernels in interpret mode
(the one-hot matmul gather for tables of <= 2048 rows, the transpose kernel
behind the native gather above that, the linear count) and against XLA's
``table[idx]`` / ``searchsorted``. Tolerance: exact (a gather is a copy,
a count an integer).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.gather import (
    _count_less_pallas,
    _gather_cols_pallas,
    _transpose_cols_pallas,
)
from pupiloptixlab_tpu.accel.gather import count_less as jax_count_less
from pupiloptixlab_tpu.accel.gather import gather_cols as jax_gather_cols
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel.gather import (
    count_less,
    count_less_plain,
    gather_cols,
    gather_planes_plain,
    gather_rows,
)
from pupiloptixlab_tpu_torch.flatten import flatten_scene

DATA = Path(__file__).resolve().parent.parent / "data"


def _table(r, t, c):
    table = r.standard_normal((t, c)).astype(np.float32) * 100.0
    # integer ids packed as floats must survive exactly
    table[:, min(3, c - 1)] = r.integers(0, 300000, size=t).astype(np.float32)
    return table


@pytest.mark.parametrize("t_rows,c", [(7, 12), (300, 16), (2048, 24), (64, 129)])
def test_gather_matches_onehot_kernel(t_rows, c):
    r = np.random.default_rng(t_rows + c)
    table = _table(r, t_rows, c)
    idx = r.integers(-5, t_rows + 5, size=3000).astype(np.int32)
    want = np.asarray(
        _gather_cols_pallas(jnp.asarray(table.T), jnp.asarray(idx), interpret=True)
    )
    got = gather_cols(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == (c, 3000)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("t_rows,c", [(5000, 12), (20544, 26), (8385, 12), (8192, 3)])
def test_gather_matches_transpose_kernel(t_rows, c):
    r = np.random.default_rng(t_rows)
    table = _table(r, t_rows, c)
    idx = r.integers(0, t_rows, size=2048).astype(np.int32)
    want = np.asarray(_transpose_cols_pallas(jnp.asarray(table)[jnp.asarray(idx)],
                                             interpret=True))
    got = gather_cols(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gather_rows(torch.from_numpy(table),
                                              torch.from_numpy(idx)).numpy(), want.T)


def test_gather_clamps_out_of_range():
    table = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([-3, 0, 9, 12], dtype=torch.int32)
    want = table[torch.tensor([0, 0, 9, 9])].T
    assert torch.equal(gather_cols(table, idx), want)
    assert torch.equal(gather_planes_plain(table, idx.long()), want)


@pytest.mark.parametrize("t_rows", [5, 65, 512, 1300])
def test_count_matches_linear_kernel(t_rows):
    r = np.random.default_rng(t_rows)
    table = np.sort(r.random(t_rows, dtype=np.float32))
    table[t_rows // 3: t_rows // 2] = table[t_rows // 3]  # a flat run
    q = r.random(4000, dtype=np.float32)
    q[:t_rows] = table[::-1][:min(t_rows, 4000)]  # exact table values
    want = np.asarray(jnp.searchsorted(jnp.asarray(table), jnp.asarray(q), side="left"))
    got = count_less(torch.from_numpy(table), torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if t_rows <= 1024:
        ref = np.asarray(_count_less_pallas(jnp.asarray(table), jnp.asarray(q),
                                            interpret=True))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_count_plain_chunks():
    """The plain count walks the queries in chunks; a query count past one
    chunk must give the same answer as one pass."""
    r = np.random.default_rng(9)
    table = torch.from_numpy(np.sort(r.random(33, dtype=np.float32)))
    q = torch.from_numpy(r.random(70000, dtype=np.float32))
    want = torch.searchsorted(table, q, side="left").to(torch.int32)
    assert torch.equal(count_less_plain(table, q), want)


@pytest.fixture(scope="module")
def mesh_env_tables():
    return flatten_scene(load_scene(DATA / "mesh_env.xml"), device="cpu")[0]


@pytest.mark.parametrize("name", ["attrs", "env_col_cdf", "pool", "pool_bi", "row_weight"])
def test_real_tables_match_reference(mesh_env_tables, name):
    d = mesh_env_tables
    table = {
        "attrs": d.tris.attrs, "env_col_cdf": d.emitters.env_col_cdf,
        "pool": d.textures.pool, "pool_bi": d.textures.pool_bi,
        "row_weight": d.emitters.env_row_weight[:, None],
    }[name]
    r = np.random.default_rng(len(name))
    idx = r.integers(-2, table.shape[0] + 2, size=4096).astype(np.int32)
    want = np.asarray(jax_gather_cols(jnp.asarray(table.numpy()), jnp.asarray(idx)))
    np.testing.assert_array_equal(gather_cols(table, torch.from_numpy(idx)).numpy(), want)


def test_real_row_cdf_matches_reference(mesh_env_tables):
    cdf = mesh_env_tables.emitters.env_row_cdf
    assert bool((cdf[1:] >= cdf[:-1]).all())
    q = np.random.default_rng(0).random(8192, dtype=np.float32)
    q[:65] = cdf.numpy()
    want = np.asarray(jax_count_less(jnp.asarray(cdf.numpy()), jnp.asarray(q)))
    np.testing.assert_array_equal(count_less(cdf, torch.from_numpy(q)).numpy(), want)


def test_cpu_wrappers_do_not_count_launches():
    kernels.reset_launches()
    t = torch.ones(4, 3)
    gather_cols(t, torch.zeros(5, dtype=torch.int32))
    count_less(torch.arange(4.0), torch.rand(5))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_device_tensors_never_take_the_plain_version(monkeypatch):
    """Tensors off the CPU go to the kernel launcher (which raises here: no
    nvcc, no card); the wrappers never fall back to the plain versions."""
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    kernels.reset_launches()
    table = torch.zeros((10, 4), device="meta")
    with pytest.raises(RuntimeError, match="launch gather_planes"):
        gather_cols(table, torch.zeros(5, dtype=torch.int32, device="meta"))
    with pytest.raises(RuntimeError, match="launch count_less"):
        count_less(torch.zeros(10, device="meta"), torch.zeros(5, device="meta"))
    with pytest.raises(ValueError, match="float32"):
        count_less(torch.zeros(10, dtype=torch.float64, device="meta"),
                   torch.zeros(5, device="meta"))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
