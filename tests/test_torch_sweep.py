"""Port parity: the chunk sweep (K5 closest hit, K6 any hit), on the CPU.

On CPU tensors ``sweep_closest`` / ``sweep_anyhit`` run their plain versions
(the brute-force sweep in ``_mt_planes``'s arithmetic over every row, no
culling, ties at equal t going to the lowest row). They are held against:

* the reference's Pallas kernels ``sweep_triangles`` / ``sweep_triangles_any``
  in interpret mode (rb 4, 1,024 rays) on seeded soups of 128, 512 and 2,560
  rows, one for each branch of ``sweep_triangles`` (the chunk grid, the
  unrolled loop, the culled loop over two super-boxes). Rows equal; t rtol
  3e-5, because the TPU kernel takes an approximate reciprocal plus one
  Newton step for 1/det.
* the reference's XLA sweep ``_sweep_tris_xla`` on 2,048 rays: t rtol 1e-6
  plus atol 3e-6. XLA's CPU backend may contract a*b+c into one FMA where
  PyTorch rounds each op; the dot products behind t cancel in scene units
  (ray origins 4 to 5 units from the soup), so the error is a few ulps of
  that distance, not of t (measured: 4.5e-6 absolute at t = 3.2).

A differing row is allowed only where both rows give the port exactly the
same t (a tie); the tests count those ties and bound them.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.intersect import _sweep_tris_xla
from pupiloptixlab_tpu.accel.pallas_intersect import sweep_triangles, sweep_triangles_any
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu_torch import kernels
from pupiloptixlab_tpu_torch.accel import sweep as sw
from pupiloptixlab_tpu_torch.accel.bvh_traverse import sweep_boxes
from pupiloptixlab_tpu_torch.accel.intersect import _mt_planes
from pupiloptixlab_tpu_torch.render.vec import Vec3 as TVec3

MAX_DISTANCE = 1e16
ROWS = [128, 512, 2560]


def _soup(rows):
    """Seeded soup of ``rows`` table rows (the last 5 all-zero padding),
    sorted along x so that chunks are compact, with chunk boxes built as
    the flatten builds them (padding rows excluded)."""
    r = np.random.default_rng(rows)
    valid = rows - 5
    p0 = (r.random((valid, 3), dtype=np.float32) * 4 - 2)
    p0 = p0[np.argsort(p0[:, 0])]
    e1 = (r.random((valid, 3), dtype=np.float32) - 0.5) * 0.5
    e2 = (r.random((valid, 3), dtype=np.float32) - 0.5) * 0.5
    packed = np.zeros((rows, 12), np.float32)
    packed[:valid, 0:3], packed[:valid, 3:6], packed[:valid, 6:9] = p0, e1, e2
    lo = np.full((rows, 3), 1e30, np.float32)
    hi = np.full((rows, 3), -1e30, np.float32)
    verts = np.stack([p0, p0 + e1, p0 + e2])
    lo[:valid], hi[:valid] = verts.min(0), verts.max(0)
    boxes = np.zeros((rows // 64, 8), np.float32)
    boxes[:, 0:3] = lo.reshape(-1, 64, 3).min(1)
    boxes[:, 3:6] = hi.reshape(-1, 64, 3).max(1)
    return packed, boxes


def _rays(seed, n):
    r = np.random.default_rng(seed)
    ro = np.zeros((n, 3), np.float32)
    ro[:, 2] = -4.0
    ro += r.random((n, 3), dtype=np.float32) - 0.5
    rd = r.random((n, 3), dtype=np.float32) - 0.5
    rd[:, 2] += 1.2
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = np.full(n, 1e-3, np.float32)
    tmax = np.full(n, MAX_DISTANCE, np.float32)
    tmax[::7] = 4.0    # short intervals: a hit beyond them is no hit
    tmax[::31] = -1.0  # culled lanes (empty interval)
    return [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2], tmin, tmax]


def _port(planes, packed, boxes):
    p = [torch.from_numpy(np.ascontiguousarray(a)) for a in planes]
    tri, bx = torch.from_numpy(packed), torch.from_numpy(boxes)
    rows = tri.shape[0] - 5  # _soup's live rows
    t, i = sw.sweep_closest(*p, tri, bx, rows=rows)
    occ = sw.sweep_anyhit(*p, tri, bx, rows=rows)
    assert t.dtype == torch.float32 and i.dtype == torch.int32 and occ.dtype == torch.int32
    return t.numpy(), i.numpy(), occ.numpy()


def _mt_t(planes, packed, rows):
    p = [torch.from_numpy(np.ascontiguousarray(a)) for a in planes]
    tri = torch.from_numpy(packed)[torch.from_numpy(rows.astype(np.int64))]
    _, t, _, _ = _mt_planes(
        TVec3(*p[0:3]), TVec3(*p[3:6]),
        TVec3(tri[:, 0], tri[:, 1], tri[:, 2]), TVec3(tri[:, 3], tri[:, 4], tri[:, 5]),
        TVec3(tri[:, 6], tri[:, 7], tri[:, 8]),
    )
    return t.numpy()


def _compare(planes, packed, got_t, got_i, want_t, want_i, rtol, atol=0.0, max_ties=2):
    hit = want_i >= 0
    np.testing.assert_array_equal(got_i >= 0, hit)
    diff = np.nonzero(got_i != want_i)[0]
    if diff.size:  # the port must see the reference's row at exactly its own best t
        t_other = _mt_t([a[diff] for a in planes], packed, want_i[diff])
        np.testing.assert_array_equal(t_other, got_t[diff])
    assert diff.size <= max_ties, f"{diff.size} row ties"
    np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=rtol, atol=atol)
    assert (got_t[~hit] == MAX_DISTANCE).all()
    return diff.size


@pytest.mark.parametrize("rows", ROWS)
def test_plain_sweep_matches_pallas_kernels(rows):
    packed, boxes = _soup(rows)
    planes = _rays(rows + 1, 1024)
    t, i, occ = _port(planes, packed, boxes)
    args = [jnp.asarray(a) for a in planes]
    wt, wi = sweep_triangles(*args, jnp.asarray(packed), jnp.asarray(boxes),
                             rb=4, tc=64, interpret=True)
    wocc = sweep_triangles_any(*args, jnp.asarray(packed), jnp.asarray(boxes),
                               rb=4, tc=64, interpret=True)
    wt, wi, wocc = np.asarray(wt), np.asarray(wi), np.asarray(wocc)
    assert (wi >= 0).any() and (wi < 0).any()
    ties = _compare(planes, packed, t, i, wt, wi, rtol=3e-5)
    print(f"{rows} rows: {int((wi >= 0).sum())} hits, {ties} exact-t ties of 1024 rays")
    np.testing.assert_array_equal(occ != 0, wocc != 0)
    np.testing.assert_array_equal(occ != 0, i >= 0)
    assert (i[planes[7] < 0] == -1).all()  # culled lanes miss


@pytest.mark.parametrize("rows", ROWS)
def test_plain_sweep_matches_xla_sweep(rows):
    packed, boxes = _soup(rows)
    planes = _rays(rows + 2, 2048)
    t, i, _ = _port(planes, packed, boxes)
    jro, jrd = JVec3(*map(jnp.asarray, planes[0:3])), JVec3(*map(jnp.asarray, planes[3:6]))
    scene_ns = SimpleNamespace(tris=SimpleNamespace(packed=jnp.asarray(packed)))
    wt, wp, wk = (np.asarray(a) for a in _sweep_tris_xla(
        jro, jrd, jnp.asarray(planes[6]), jnp.asarray(planes[7]), scene_ns))
    wi = np.where(wk >= 0, wp, -1)
    _compare(planes, packed, t, i, wt, wi, rtol=1e-6, atol=3e-6)


def test_ties_go_to_the_lowest_row():
    """The same triangle stored in rows 3, 70 and 200 (three chunks): every
    hit reports row 3, as the reference's argmin and strict < do."""
    packed, boxes = _soup(256)
    tri = np.array([-3, -3, 0, 6, 0, 0, 0, 6, 0, 0, 0, 0], np.float32)
    for row in (3, 70, 200):
        packed[row] = tri
    planes = _rays(9, 512)
    t, i, occ = _port(planes, packed, boxes)
    jt, ji = sweep_triangles(*[jnp.asarray(a) for a in planes], jnp.asarray(packed),
                             jnp.asarray(boxes), rb=4, tc=64, interpret=True)
    on_big = np.isin(i, (3, 70, 200))
    assert on_big.sum() > 50 and (i[on_big] == 3).all()
    np.testing.assert_array_equal(i, np.asarray(ji))


@pytest.mark.parametrize("n_chunks,groups", [(1, 1), (32, 1), (33, 2), (321, 11)])
def test_super_boxes_match_the_reference_wrapper(n_chunks, groups):
    """group_count against the reference wrapper's, and the super-boxes of
    ``sweep_boxes`` (the port's padded ones, after the chunk boxes) hold
    the reference wrapper's own (pallas_intersect.py:389-405, never-hit
    padding included) over the flatten's chunk boxes of a seeded table."""
    assert sw.group_count(n_chunks) == groups
    r = np.random.default_rng(n_chunks)
    rows = n_chunks * 64
    packed = np.zeros((rows, 12), np.float32)
    live = rows - 37
    packed[:live, 0:3] = r.random((live, 3), dtype=np.float32) * 8 - 4
    packed[:live, 3:9] = r.random((live, 6), dtype=np.float32) - 0.5
    got = sweep_boxes(torch.from_numpy(packed)).numpy()
    if groups == 1:
        assert got.shape == (n_chunks, 8)
        return
    assert got.shape == (n_chunks + groups, 8)
    v = np.stack([packed[:live, 0:3], packed[:live, 0:3] + packed[:live, 3:6],
                  packed[:live, 0:3] + packed[:live, 6:9]])
    lo = np.full((rows, 3), 1e30, np.float32)
    hi = np.full((rows, 3), -1e30, np.float32)
    lo[:live], hi[:live] = v.min(0), v.max(0)
    boxes = np.zeros((n_chunks, 8), np.float32)
    boxes[:, 0:3] = lo.reshape(-1, 64, 3).min(1)
    boxes[:, 3:6] = hi.reshape(-1, 64, 3).max(1)
    pad = groups * sw.GROUP - n_chunks
    never = np.tile(np.array([[1e30] * 3 + [-1e30] * 3 + [0, 0]], np.float32), (pad, 1))
    grp = np.concatenate([boxes, never]).reshape(groups, sw.GROUP, 8)
    want = np.concatenate([grp[:, :, 0:3].min(1), grp[:, :, 3:6].max(1)], 1)
    sup = got[n_chunks:]
    assert (sup[:, 0:3] <= want[:, 0:3]).all() and (sup[:, 3:6] >= want[:, 3:6]).all()
    assert (sup[:, 6:8] == 0).all()
    # padded by 2^-13 of the box's largest |coordinate| and 2^-19 of the table's
    np.testing.assert_allclose(sup[:, 0:6], want, atol=(2.0 ** -13 + 2.0 ** -19) * 4.5 + 1e-6)


def test_arguments_are_checked():
    p = [torch.zeros(4, device="meta") for _ in range(8)]
    tri = torch.zeros((64, 12), device="meta")
    boxes = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="multiple of 64"):
        sw.sweep_closest(*p, torch.zeros((60, 12), device="meta"), boxes, rows=60)
    with pytest.raises(ValueError, match="1 chunk boxes and 0 super-boxes"):
        sw.sweep_anyhit(*p, tri, torch.zeros((2, 8), device="meta"), rows=64)
    with pytest.raises(ValueError, match="ray plane 7"):
        sw.sweep_closest(*p[:7], torch.zeros(5, device="meta"), tri, boxes, rows=64)
    with pytest.raises(ValueError, match="tri must be"):
        sw.sweep_closest(*p, tri.to(torch.float64), boxes, rows=64)
    big = torch.zeros((40 * 64, 12), device="meta")
    with pytest.raises(ValueError, match="40 chunk boxes and 2 super-boxes"):
        sw.sweep_closest(*p, big, torch.zeros((41, 8), device="meta"), rows=2555)


def test_device_tensors_never_take_the_plain_version(monkeypatch):
    """A tensor off the CPU goes to the kernel launcher (which raises here:
    no nvcc, no card); the wrappers never fall back to the plain sweep, and
    the launch counters count launches only."""
    def no_launcher(name):
        raise RuntimeError(f"launch {name}")

    monkeypatch.setattr(kernels, "launcher", no_launcher)
    kernels.reset_launches()
    p = [torch.zeros(4, device="meta") for _ in range(8)]
    tri = torch.zeros((64, 12), device="meta")
    boxes = torch.zeros((1, 8), device="meta")
    for fn, name in ((sw.sweep_closest, "sweep_closest"), (sw.sweep_anyhit, "sweep_anyhit")):
        with pytest.raises(RuntimeError, match=f"launch {name}"):
            fn(*p, tri, boxes, rows=64)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    planes = [torch.from_numpy(a) for a in _rays(1, 64)]
    packed, bx = (torch.from_numpy(a) for a in _soup(128))
    sw.sweep_closest(*planes, packed, bx, rows=123)
    sw.sweep_anyhit(*planes, packed, bx, rows=123)
    assert all(v == 0 for v in kernels.LAUNCHES.values())  # the CPU path launches nothing
