"""Port parity: plane gathers (K3) and CDF counts (K4) on the CPU.

The port's wrappers run their plain versions for CPU tensors; these are
held bit for bit against the reference's Pallas kernels in interpret mode
(the one-hot matmul gather for tables of <= 2048 rows, the transpose kernel
behind the native gather above that, the linear count) and against XLA's
``table[idx]`` / ``searchsorted``. The port's own forms, column-selected
gathers (``cols=``) and the row-indexed count (``rows=``, the envmap's
column inversion), are held against the reference's whole-row gathers and
its gather-compare-sum. Tolerance: exact (a gather is a copy, a count an
integer).
"""

from pathlib import Path

import jax
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
    gather_fields,
    gather_planes,
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


# --- the port's own forms: column selection and the row-indexed count ---------

def test_env_cdfs_are_nondecreasing(mesh_env_tables):
    """The row-indexed count is a binary search: it equals the linear count
    only on nondecreasing rows, which the flattened env CDFs must be."""
    em = mesh_env_tables.emitters
    row, col = em.env_row_cdf, em.env_col_cdf
    assert bool((row[1:] >= row[:-1]).all())
    assert tuple(col.shape) == (64, 129)
    assert bool((col[:, 1:] >= col[:, :-1]).all())


def test_row_count_matches_reference_column_inversion(mesh_env_tables):
    """count_less(env_col_cdf, u2, rows=row) against the reference's envmap
    column inversion (render/emitter.py: gather_cols of the whole row, then
    sum(rows < u2)) and jnp.searchsorted in each row, on mesh_env's table
    with a black row appended (its CDF is 0 except the last entry, 1.0, as
    flatten gives it): exact table values, a flat run of equal draws, rows
    out of range."""
    col = mesh_env_tables.emitters.env_col_cdf.numpy()
    black = np.zeros((1, col.shape[1]), np.float32)
    black[0, -1] = 1.0
    table = np.concatenate([col, black])
    h = table.shape[0]
    r = np.random.default_rng(7)
    n = 4096
    rows = r.integers(-2, h + 2, n).astype(np.int32)
    rows[:256] = h - 1  # the black row
    u2 = r.random(n, dtype=np.float32)
    safe = np.clip(rows, 0, h - 1)
    j = r.integers(0, table.shape[1], n)
    u2[256:1280] = table[safe[256:1280], j[256:1280]]  # exact entries of each row
    u2[1280:1536] = u2[1280]  # a flat run of draws
    u2[:64] = 0.0
    got = count_less(torch.from_numpy(table), torch.from_numpy(u2), rows=torch.from_numpy(rows))
    assert got.dtype == torch.int32
    jt, ju, jr = jnp.asarray(table), jnp.asarray(u2), jnp.asarray(rows)
    want = np.asarray(jnp.sum(jax_gather_cols(jt, jr) < ju[None, :], axis=0))
    np.testing.assert_array_equal(got.numpy(), want)
    per_row = jax.vmap(lambda t, x: jnp.searchsorted(t, x, side="left"))(
        jt[jnp.clip(jr, 0, h - 1)], ju)
    np.testing.assert_array_equal(got.numpy(), np.asarray(per_row))
    assert int(got[:64].max()) == 0 and int(got[256:1280].min()) >= 0


@pytest.mark.parametrize("name,cols", [("attrs", (15, 16)), ("attrs", (0, 1, 2, 9, 25)),
                                       ("materials", (1,)), ("textures", (1, 2, 3)),
                                       ("textures", (13, 7, 18))])
def test_column_selection_matches_full_gather_and_reference(mesh_env_tables, name, cols):
    d = mesh_env_tables
    table = {"attrs": d.tris.attrs, "materials": d.materials.packed,
             "textures": d.textures.packed}[name]
    r = np.random.default_rng(len(cols))
    idx = torch.from_numpy(r.integers(-3, table.shape[0] + 3, 2048).astype(np.int32))
    got = gather_cols(table, idx, cols)
    assert tuple(got.shape) == (len(cols), 2048)
    full = gather_cols(table, idx)
    assert torch.equal(got, full[list(cols)])
    ref = np.asarray(jax_gather_cols(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(got.numpy(), ref[list(cols)])
    fields = gather_fields(table, idx, cols)
    for c in cols:
        assert torch.equal(fields[c], full[c])


def test_gathers_read_strided_tables_in_place():
    """A column slice and a view with unit strides gather as their copies
    do; an index out of range clamps."""
    r = np.random.default_rng(3)
    base = torch.from_numpy(_table(r, 40, 16))
    idx = torch.tensor([-4, 0, 7, 39, 55, 12], dtype=torch.int32)
    sliced = base[:, 5:11]
    assert not sliced.is_contiguous()
    want = gather_cols(sliced.contiguous(), idx)
    assert torch.equal(gather_cols(sliced, idx), want)
    assert torch.equal(gather_cols(sliced, idx, (1, 4)), want[[1, 4]])
    assert torch.equal(gather_cols(base, idx, (6, 9)), want[[1, 4]])
    w = torch.from_numpy(r.random(9, dtype=np.float32))
    pairs = w.unfold(0, 2, 1)  # (8, 2), strides (1, 1)
    want = torch.stack([w[:-1], w[1:]], dim=1)[idx.clamp(0, 7).long()].T
    assert torch.equal(gather_cols(pairs, idx), want)
    one = gather_fields(base, torch.tensor([3], dtype=torch.int32), (2, 8), n=5)
    assert tuple(one.planes.shape) == (2, 5) and bool((one[8] == base[3, 8]).all())


@pytest.mark.parametrize("cols", [(), (16,), (-1,), (0, 2.0), "0"])
def test_bad_column_selections_raise(cols):
    table = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="cols"):
        gather_cols(table, torch.zeros(3, dtype=torch.int32), cols)


@pytest.mark.parametrize("rows", [torch.zeros(5, dtype=torch.int64), torch.zeros(5),
                                  torch.zeros(4, dtype=torch.int32),
                                  torch.zeros((5, 1), dtype=torch.int32)])
def test_bad_rows_raise(rows):
    with pytest.raises(ValueError, match="rows"):
        count_less(torch.zeros((3, 8)), torch.rand(5), rows=rows)
    with pytest.raises(ValueError, match="table"):
        count_less(torch.zeros(8), torch.rand(5), rows=torch.zeros(5, dtype=torch.int32))


def test_device_forms_reach_the_launcher(monkeypatch):
    """Column-selected gathers and the row-indexed count on tensors off the
    CPU go to the kernel launcher too (which raises here)."""
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    kernels.reset_launches()
    table = torch.zeros((10, 16), device="meta")
    idx = torch.zeros(5, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="launch gather_planes"):
        gather_planes(table[:, 3:9], idx, (0, 5))
    with pytest.raises(RuntimeError, match="launch count_less"):
        count_less(torch.zeros((4, 9), device="meta"), torch.zeros(5, device="meta"),
                   rows=idx)
    with pytest.raises(ValueError, match="idx"):
        gather_planes(table, idx.long(), (1,))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
