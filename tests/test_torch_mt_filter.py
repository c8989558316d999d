"""K10's tensor-core filter and its exact test, held on the CPU.

K10 (``bvh_closest_mt``, csrc/bvh_traverse.cu) tests each pending leaf of
a warp's leaf step through one TF32 product of the rays' features with
the leaf's fragment-order table (``mt_frag_table``), rejects the pairs
whose u*det, v*det and w*det surely differ in sign (``mt_filter_rejects``),
and runs the FP32 linear form on what passes through its 19 non-zero
products (``mt_lean_hit_t``). Held here:

* the fragment-order table decodes to the port's ``mt_cols_table`` and the
  reference's ``_mt_cols_table`` (pallas_bvh.py:259) after TF32 rounding;
* the 19-product test equals ``mt_linear_hit_t`` (t equal, the same hits);
* the filter's margins never reject a pair whose FP32 sign tests pass, with
  the tensor cores' sums allowed to err by 2^-18 of the terms' magnitudes in
  the worst direction, on seeded, edge-aimed, vertex-aimed, grazing, far
  (1e3 extents) and axis-aligned (zero-component) rays over a soup, and on
  mesh_env's camera rays over its 32-row table;
* the share of pairs it rejects on the leaves that hold mesh_env's hits;
* the kernel's lane arithmetic (fragments, C layout, quad OR, the owner
  lane's mask) against the same filter pair by pair, emulated for a warp.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.accel.bvh import build_bvh
from pupiloptixlab_tpu.accel.pallas_bvh import _mt_cols_table
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
from pupiloptixlab_tpu_torch.render.camera import generate_rays
from pupiloptixlab_tpu_torch.scene import load_scene

DATA = Path(__file__).resolve().parent.parent / "data"
TC_SUM_ERR = 2.0 ** -18  # the tensor cores' FP32 sum, relative to sum |f_k g_k|


@pytest.fixture(scope="module")
def soup():
    """tests/test_bvh.py's soup of 2,100 triangles in 32-row leaves, in tree
    order, as a (T, 12) packed table, and its centre."""
    r = np.random.RandomState(77)
    t, tcl = 2100, 32
    t_pad = ((t + tcl - 1) // tcl) * tcl
    p0 = np.zeros((t_pad, 3), np.float32)
    p1, p2 = np.zeros_like(p0), np.zeros_like(p0)
    p0[:t] = r.rand(t, 3).astype(np.float32) * 4 - 2
    p1[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    p2[:t] = p0[:t] + (r.rand(t, 3).astype(np.float32) - 0.5) * 0.4
    o = build_bvh(p0, p1, p2, t, tcl).order
    packed = np.concatenate([p0[o], p1[o] - p0[o], p2[o] - p0[o],
                             np.zeros((t_pad, 3), np.float32)], 1)
    tri = torch.from_numpy(packed)
    return tri, bt.mt_center(tri)


@pytest.fixture(scope="module")
def mesh_env():
    """mesh_env's 32-row table (PUPIL_TCL=32) and the camera rays of every
    other pixel of a 32x18 film."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PUPIL_TCL", "32")
    try:
        scene = load_scene(DATA / "mesh_env.xml")
        scene.sensor.film.w, scene.sensor.film.h = 32, 18
        data, config = flatten_scene(scene, device="cpu")
    finally:
        mp.undo()
    cam = camera_block_from_scene(scene, device="cpu")
    g = np.random.default_rng(4)
    n = config.width * config.height
    jx, jy = (torch.from_numpy(g.random(n, dtype=np.float32)) for _ in range(2))
    ro, rd = generate_rays(cam, config.width, config.height, jx, jy)
    # every other pixel: 288 rays
    rays = tuple(x[::2].contiguous() for x in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z,
                                               torch.full((n,), 1e-4),
                                               torch.full((n,), bt.MAX_DISTANCE)))
    assert config.bvh_tcl == 32
    return data.tris.packed, rays


def _unit(v):
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _aimed(targets, dirs, back=3.0):
    """Rays toward ``targets`` along ``dirs`` from ``back`` before them."""
    o = (targets - back * dirs).astype(np.float32)
    d = dirs.astype(np.float32)
    n = o.shape[0]
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                 (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                  np.full(n, 1e-3, np.float32), np.full(n, bt.MAX_DISTANCE, np.float32)))


def _family(name, tri):
    """Rays of one family over the soup's table (numpy seed 5)."""
    r = np.random.default_rng(5)
    packed = tri.numpy().astype(np.float64)
    live = np.nonzero(np.abs(packed[:, 3:9]).sum(1) > 0)[0]
    rows = r.choice(live, 256)
    p0, e1, e2 = packed[rows, 0:3], packed[rows, 3:6], packed[rows, 6:9]
    nrm = _unit(np.cross(e1, e2))
    a = r.random((256, 1))
    if name == "seeded":
        ro = np.zeros((512, 3), np.float32)
        ro[:, 2] = -4.0
        ro += (r.random((512, 3)).astype(np.float32) - 0.5)
        rd = r.random((512, 3)).astype(np.float32) - 0.5
        rd[:, 2] += 1.2
        return _aimed(ro + 3.0 * _unit(rd), _unit(rd))
    if name == "edge":
        side = r.integers(0, 3, (256, 1))
        tgt = np.where(side == 0, p0 + a * e1,
                       np.where(side == 1, p0 + a * e2, p0 + e1 + a * (e2 - e1)))
        return _aimed(tgt, _unit(nrm + 0.5 * r.standard_normal((256, 3))))
    if name == "vertex":
        side = r.integers(0, 3, (256, 1))
        tgt = np.where(side == 0, p0, np.where(side == 1, p0 + e1, p0 + e2))
        return _aimed(tgt, _unit(nrm + 0.5 * r.standard_normal((256, 3))))
    if name == "grazing":
        tgt = p0 + 0.3 * e1 + 0.3 * e2
        eps = np.choose(r.integers(0, 3, 256), [0.0, 1e-5, 1e-3])[:, None]
        return _aimed(tgt, _unit(_unit(e1 - e2) + eps * nrm))
    if name == "far":
        tgt = p0 + 0.25 * e1 + 0.25 * e2
        o = 1e3 * _unit(r.standard_normal((256, 3)))
        return _aimed(tgt, _unit(tgt - o), back=np.linalg.norm(tgt - o, axis=1,
                                                                        keepdims=True))
    if name == "axis":
        tgt = p0 + 0.2 * e1 + 0.3 * e2
        ax = r.integers(0, 3, 256)
        d = np.zeros((256, 3))
        d[np.arange(256), ax] = np.where(r.random(256) < 0.5, -1.0, 1.0)
        return _aimed(tgt, d)
    raise ValueError(name)


def _dots(f, cols):
    """The four linear-form dots of every pair (rays x rows), summed left to
    right over 10 terms in float32, as ``mt_linear_hit_t``."""
    def dot(base):
        acc = f[0][:, None] * cols[base][None, :]
        for k in range(1, 10):
            acc = acc + f[k][:, None] * cols[base + k][None, :]
        return acc
    return dot(0), dot(10), dot(20), dot(30)


def _pairs(rays, tri):
    """Per pair of ``rays`` x the rows of ``tri``: whether the FP32 sign
    tests of ``mt_linear_hit_t`` pass, and whether the filter rejects the
    pair when the tensor cores' sums err by TC_SUM_ERR in the direction that
    rejects; the filter's own rejections too."""
    rows, center = bt.mt_tables(tri)
    f = bt._mt_features(*rays[:6], center)
    det, up, vp, _ = _dots(f, list(rows.unbind(1)))
    sign_ok = ((det.abs() >= 1e-12) & (up * det >= 0) & (vp * det >= 0)
               & ((det - up - vp) * det >= 0))
    q, big_g = bt.mt_filter_factors(tri, center)
    ft = torch.stack([bt.tf32_round(x) for x in f[:6]], 1).double()  # (R, 6)
    ss = f[0] * f[0]
    for k in range(1, 6):
        ss = ss + f[k] * f[k]
    rn = torch.sqrt(ss) * (1.0 + 2.0 ** -20)
    vals, errs = [], []
    for k in range(3):
        g = q[:, k, :6].double()  # (T, 6)
        vals.append((ft @ g.T).float())
        errs.append((TC_SUM_ERR * (ft.abs() @ g.abs().T)).float())
    rej = bt.mt_filter_rejects(*vals, rn[:, None], big_g[None, :])
    # the worst case: some value up by its error, another down by its own
    hi = torch.maximum(torch.maximum(vals[0] + errs[0], vals[1] + errs[1]), vals[2] + errs[2])
    lo = torch.minimum(torch.minimum(vals[0] - errs[0], vals[1] - errs[1]), vals[2] - errs[2])
    m = (rn[:, None].double() * big_g[None, :].double() + 2.0 ** -100).float()
    worst = (hi > m) & (lo < -m)
    return sign_ok, rej, worst


def test_frag_table_holds_the_reference_columns(soup):
    tri, center = soup
    t_rows = tri.shape[0]
    frag = bt.mt_frag_table(tri, center).reshape(t_rows // 32, 4, 2, 32, 4)
    lane = torch.arange(32)
    gid, tq = lane // 4, lane % 4
    # decode each n-tile's 8 x 8 B (k = feature, n = row 8b + n): b0 at
    # (k = t, n = g), b1 at (k = t + 4, n = g)
    dec = torch.zeros((t_rows // 32, 4, 3, 8, 8))  # leaf, block, u/v/w, row n, feature k
    for qty, (half, c0) in enumerate(((0, 0), (0, 2), (1, 0))):
        dec[:, :, qty, gid, tq] = frag[:, :, half, :, c0]
        dec[:, :, qty, gid, tq + 4] = frag[:, :, half, :, c0 + 1]
    dec = dec.permute(0, 1, 3, 2, 4).reshape(t_rows, 3, 8)  # row, u/v/w, feature
    ours = bt.mt_cols_table(tri, center)  # (10, 4T), leaf-grouped [det|u|v|t] x 32
    ref = torch.from_numpy(np.array(_mt_cols_table(jnp.asarray(tri.numpy()),
                                                   jnp.asarray(center.numpy()))))
    j = torch.arange(t_rows)
    col = 128 * (j // 32) + j % 32
    for cols, exact in ((ours, True), (ref, False)):
        det, u, v = (cols[:8, col + 32 * k].T for k in range(3))
        w = (det.double() - u.double() - v.double()).float()
        for qty, want in enumerate((u, v, w)):
            got = dec[:, qty]
            if exact:
                assert torch.equal(got, bt.tf32_round(want))
            else:  # the reference's cross products may differ by an FMA's rounding
                torch.testing.assert_close(got, bt.tf32_round(want), rtol=2.0 ** -9,
                                           atol=1e-6)
    # the margin factors: row 8b + 2t (+ 1) in lane (g, t) of every g
    big_g = bt.mt_filter_factors(tri, center)[1].reshape(t_rows // 32, 4, 8)
    for c in (0, 1):
        assert torch.equal(frag[:, :, 1, :, 2 + c], big_g[:, :, 2 * tq + c])
    # the features 6 and 7 of u, v and w are structural zeros
    assert not dec[:, :, 6:].any()


@pytest.mark.parametrize("name", ["seeded", "edge", "vertex", "grazing", "far", "axis"])
def test_lean_form_equals_linear_form(soup, name):
    tri, _ = soup
    rays = _family(name, tri)
    rows, center = bt.mt_tables(tri)
    lean = bt.mt_lean_table(rows)
    f = [x[:, None] for x in bt._mt_features(*rays[:6], center)]
    tmn, tmx = rays[6][:, None], rays[7][:, None]
    want = bt.mt_linear_hit_t(f, tmn, tmx, [c[None, :] for c in rows.unbind(1)])
    got = bt.mt_lean_hit_t(f, tmn, tmx, [c[None, :] for c in lean.unbind(1)[:19]])
    assert torch.equal(got, want)
    assert (want < bt.MAX_DISTANCE).sum() > 0


@pytest.mark.parametrize("name", ["seeded", "edge", "vertex", "grazing", "far", "axis"])
def test_filter_never_rejects_a_pair_that_can_hit(soup, name):
    tri, _ = soup
    sign_ok, rej, worst = _pairs(_family(name, tri), tri)
    assert sign_ok.sum() > 0
    assert not (sign_ok & rej).any()
    assert not (sign_ok & worst).any(), int((sign_ok & worst).sum())


def test_filter_on_mesh_env(mesh_env):
    """The camera rays of the fixture over all 20,544 rows; then the share
    of pairs rejected on the leaf that holds each ray's hit (K10's own
    case: a ray tests the leaves it reaches)."""
    tri, rays = mesh_env
    sign_ok, rej, worst = _pairs(rays, tri)
    assert not (sign_ok & worst).any()
    hit_t, hit_row = bt.plain_closest_mt(*rays, tri)
    lanes = torch.nonzero(hit_row >= 0).squeeze(1)
    assert lanes.numel() > 200
    leaf_rows = (hit_row[lanes].long() // 32 * 32)[:, None] + torch.arange(32)[None, :]
    r_leaf = rej[lanes[:, None], leaf_rows]
    ok_leaf = sign_ok[lanes[:, None], leaf_rows]
    rate = float(r_leaf.sum()) / float((~ok_leaf).sum())
    passed = float((~r_leaf).sum(1).double().mean())
    # recorded in PERF.md: the rows of a hit leaf that reach the exact test
    print(f"mesh_env hit leaves: {rate:.4f} of the failing pairs rejected, "
          f"{passed:.2f} of 32 rows pass a ray")
    assert rate > 0.8 and passed < 8.0


def _mma(a_frag, b_frag):
    """One m16n8k8 TF32 product from its lanes' fragments (PTX layouts): a
    (32, 4) -> A (16 x 8), b (32, 2) -> B (8 x 8); returns (32, 4) D
    fragments, summed in float64."""
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for ln in range(32):
        g, t = ln // 4, ln % 4
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_frag[ln]
        B[t, g], B[t + 4, g] = b_frag[ln]
    D = A @ B
    d = np.zeros((32, 4))
    for ln in range(32):
        g, t = ln // 4, ln % 4
        d[ln] = D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]
    return d


def test_tc_filter_lane_arithmetic(soup):
    """tc_filter's steps, lane by lane, for warps of 32 rays against a leaf:
    A fragments from the lanes' features, the table's B fragments and
    margin factors, the C layout, the quad OR and the owner lane's mask,
    equal to the filter applied pair by pair."""
    tri, center = soup
    frag = bt.mt_frag_table(tri, center).numpy().reshape(-1, 4, 2, 32, 4)
    q, big_g = bt.mt_filter_factors(tri, center)
    for name, leaf in (("seeded", 3), ("edge", 17), ("vertex", 40)):
        rays = [x[:32] for x in _family(name, tri)]
        f = bt._mt_features(*rays[:6], center)
        ft = np.stack([bt.tf32_round(x).numpy() for x in f[:6]], 1)  # (32, 6)
        F = np.zeros((32, 8))
        F[:, :6] = ft
        ss = f[0] * f[0]
        for k in range(1, 6):
            ss = ss + f[k] * f[k]
        rn = (torch.sqrt(ss) * (1.0 + 2.0 ** -20)).numpy()
        part = np.zeros((32, 2, 2), np.uint64)
        for mt in range(2):
            a_frag = np.array([[F[16 * mt + ln // 4, ln % 4], F[16 * mt + 8 + ln // 4, ln % 4],
                                F[16 * mt + ln // 4, ln % 4 + 4],
                                F[16 * mt + 8 + ln // 4, ln % 4 + 4]] for ln in range(32)])
            for b in range(4):
                x, y = frag[leaf, b, 0], frag[leaf, b, 1]
                du = _mma(a_frag, x[:, 0:2]).astype(np.float32)
                dv = _mma(a_frag, x[:, 2:4]).astype(np.float32)
                dw = _mma(a_frag, y[:, 0:2]).astype(np.float32)
                for ln in range(32):
                    g, t = ln // 4, ln % 4
                    for p in range(4):
                        h, c = p >> 1, p & 1
                        rej = bt.mt_filter_rejects(
                            torch.tensor(du[ln, p]), torch.tensor(dv[ln, p]),
                            torch.tensor(dw[ln, p]), torch.tensor(rn[16 * mt + 8 * h + g]),
                            torch.tensor(y[ln, 2 + c]))
                        if not bool(rej):
                            part[ln, mt, h] |= np.uint64(1 << (8 * b + 2 * t + c))
        for ln in range(32):  # the quad's OR
            part[ln] = np.bitwise_or.reduce(part[ln - ln % 4:ln - ln % 4 + 4], axis=0)
        mask = [int(part[4 * (ln & 7), ln >> 4, (ln >> 3) & 1]) for ln in range(32)]
        # the same filter pair by pair, the products in float64
        rows = slice(32 * leaf, 32 * leaf + 32)
        vals = [torch.from_numpy(F[:, :6] @ q[rows, k, :6].double().numpy().T).float()
                for k in range(3)]
        rej = bt.mt_filter_rejects(*vals, torch.from_numpy(rn)[:, None], big_g[rows][None, :])
        want = [sum(1 << j for j in range(32) if not bool(rej[ln, j])) for ln in range(32)]
        assert mask == want, name
