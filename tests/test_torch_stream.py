"""Port parity on the CPU for the reference's streamed traversal's tables.

The reference streams triangle tables above ``STREAM_TRI_BYTES`` (8 MB, a
TPU core's VMEM budget) through a DMA ring and asks the flatten for 32-row
leaves there. The port's K1/K2 read every table from device memory, so the
same kernels serve that size (big_env, 405,002 triangles, is held on the
card by chip_smoke.py). Here the limit is lowered in both packages so that
data/mesh_env.xml takes the streaming branch at leaf size 32:

* the flattened tables and config are equal;
* the depth the port records fits the kernels' 64-entry stack;
* the port's plain closest / any-hit (the CPU route of ``bvh_closest`` /
  ``bvh_anyhit``) against the reference's XLA sweep on 2,048 rays: the same
  rows (no tie), t within rtol 1e-6 plus atol 3e-6 (XLA's FMAs), occlusion
  equal to the closest hit.
Nothing runs the reference's streamed Pallas kernel (interpret mode is slow;
the reference marks those tests heavy).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import pupiloptixlab_tpu.accel.pallas_bvh as jax_pallas_bvh
from pupiloptixlab_tpu.accel.intersect import _sweep_tris_xla
from pupiloptixlab_tpu.flatten import flatten_scene as jax_flatten
from pupiloptixlab_tpu.render.vec import Vec3 as JVec3
from pupiloptixlab_tpu.scene import load_scene
from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
from pupiloptixlab_tpu_torch.flatten import flatten as port_flatten
from pupiloptixlab_tpu_torch.flatten import flatten_scene

DATA = Path(__file__).resolve().parent.parent / "data"


def test_streaming_branch_tables_and_plain_traversal(monkeypatch):
    monkeypatch.setattr(port_flatten, "STREAM_TRI_BYTES", 512 * 1024)
    monkeypatch.setattr(jax_pallas_bvh, "STREAM_TRI_BYTES", 512 * 1024)
    scene = load_scene(DATA / "mesh_env.xml")
    jd, jc = jax_flatten(scene)
    td, tc = flatten_scene(scene, device="cpu")
    assert tc.bvh_tcl == 32 and not tc.instanced  # 16 without the lowered limit
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for f in dataclasses.fields(jd.tris):
        np.testing.assert_array_equal(getattr(td.tris, f.name).numpy(),
                                      np.asarray(getattr(jd.tris, f.name)), err_msg=f.name)
    assert bt.stack_fits(td.tris.bvh_depth) and td.tris.bvh_depth >= 3

    r = np.random.default_rng(31)
    n = 2048
    ro = (r.standard_normal((3, n)) * 2.0).astype(np.float32)
    ro[1] = np.abs(ro[1]) + 0.5
    rd = r.standard_normal((3, n)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=0, keepdims=True)
    tmin = np.full(n, 1e-4, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    planes = [np.ascontiguousarray(a) for a in (*ro, *rd, tmin, tmax)]
    p = [torch.from_numpy(a) for a in planes]
    tr = td.tris
    tabs = (tr.packed, tr.bvh_child, tr.bvh_axis, tr.bvh_boxes, tr.subleaf_rows,
            tr.subleaf_boxes)
    t, i = bt.bvh_closest(*p, *tabs, tcl=tc.bvh_tcl, depth=tr.bvh_depth)
    occ = bt.bvh_anyhit(*p, *tabs, tcl=tc.bvh_tcl, depth=tr.bvh_depth)
    j = [jnp.asarray(a) for a in planes]
    jt, jp, jk = map(np.asarray, _sweep_tris_xla(JVec3(*j[0:3]), JVec3(*j[3:6]), j[6], j[7], jd))
    hit = jk == 0
    assert 0.1 < hit.mean() < 0.9, hit.mean()
    np.testing.assert_array_equal(i.numpy() >= 0, hit)
    np.testing.assert_array_equal(i.numpy()[hit], jp[hit])
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-6, atol=3e-6)
    np.testing.assert_array_equal(occ.numpy(), hit.astype(np.int32))
