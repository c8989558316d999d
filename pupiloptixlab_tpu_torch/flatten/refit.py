"""Device-side scene refit: the IAS-refit / instance layer analog.

Counterpart of pupiloptixlab_tpu/flatten/refit.py. A transform or
visibility edit refits the scene's tables in place of a host re-flatten,
as the original refits its TLAS (world/ias_manager.cpp:116-151,
OPTIX_BUILD_OPERATION_UPDATE) and resets the touched area emitters
(world/emitter.cpp ResetAreaEmitter):

* instanced scenes (``InstRefitData``): object-space rows never move, so
  ``refit_instanced`` recomputes the per-instance matrices and the world
  leaf boxes on the host (numpy, as the reference does, so the tables are
  bit-identical), refits the world box tree bottom-up with frozen
  topology, and uploads ``inst_w2o``, ``inst_packed`` and ``bvh_boxes``;
* baked scenes (``RefitData``): ``_refit_device`` regenerates world-space
  rows from the unique object-space rows and the per-instance transforms,
  then the chunk, super and BVH boxes and the area-emitter rows and
  selection CDF, as plain PyTorch on the tables' device (the reference's
  jitted jnp function; it has no Pallas kernel), and the port's sub-leaf
  group boxes from the moved rows in the kept row order (stale boxes would
  drop hits). Shapes never change.

Refit semantics kept from the reference: the BVH keeps its topology (box
quality degrades after large moves, as an OptiX refit does), and a hidden
instance's rows keep their transformed p0 with zero edges (the flatten
collapses them to the centroid instead); either way they never hit.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from pupiloptixlab_tpu_torch.accel.bvh_traverse import baked_subleaf_boxes, sweep_boxes
from pupiloptixlab_tpu_torch.flatten.types import (
    EM_AREA,
    EM_RADIUS,
    EM_SELECT_PROB,
    EM_V0N,
    EM_V0P,
    EM_V1N,
    EM_V1P,
    EM_V2N,
    EM_V2P,
    INST_NRM,
    TRI_N0,
    TRI_N1,
    TRI_N2,
    InstRefitData,
    RefitData,
    SceneData,
)

_NEVER = np.float32(1e30)


def refit_instanced(scene_data: SceneData, refit: InstRefitData, scene) -> SceneData:
    """Instanced-scene transform/visibility refit; returns a SceneData
    with identical shapes (see InstRefitData)."""
    n_inst = refit.mesh_scene_idx.shape[0]
    o2w = np.zeros((n_inst, 3, 4), np.float64)
    w2o = np.zeros((n_inst, 12), np.float32)
    inst_packed = refit.inst_packed.copy()
    hidden = np.zeros(n_inst, bool)
    for i, si in enumerate(refit.mesh_scene_idx):
        ins = scene.shape_instances[int(si)]
        m = np.asarray(ins.transform.matrix, np.float64)
        o2w[i] = m[:3, :4]
        hidden[i] = getattr(ins, "visibility_mask", 255) == 0
        flip = -1.0 if getattr(ins, "flip_normals", False) else 1.0
        try:
            w2o[i] = np.linalg.inv(m)[:3, :4].reshape(-1).astype(np.float32)
            nrm = (np.linalg.inv(m[:3, :3]).T * flip).astype(np.float32)
        except np.linalg.LinAlgError:
            # singular transform: zero-volume instance -> treat as hidden
            # (rays cannot be mapped into its object space)
            hidden[i] = True
            nrm = np.zeros((3, 3), np.float32)
        if hidden[i]:
            w2o[i] = 0.0  # degenerate ray transform: see instanced.py
        inst_packed[i, INST_NRM] = nrm.reshape(-1)

    # world leaf boxes: 8 object corners through each leaf's instance
    lo, hi = refit.obj_leaf_lo, refit.obj_leaf_hi
    sel = np.array(
        [[(k >> a) & 1 for a in range(3)] for k in range(8)], bool
    )  # (8, 3)
    corners = np.where(sel[None], hi[:, None, :], lo[:, None, :])  # (L,8,3)
    mats = o2w[refit.leaf_inst]  # (L, 3, 4)
    wc = np.einsum("lkj,lij->lki", corners, mats[:, :, :3]) + mats[:, None, :, 3]
    lo_w = wc.min(axis=1).astype(np.float32)
    hi_w = wc.max(axis=1).astype(np.float32)
    dead = (lo[:, 0] > hi[:, 0]) | hidden[refit.leaf_inst]
    lo_w[dead] = _NEVER
    hi_w[dead] = _NEVER  # the never-box convention of accel/bvh.py

    # bottom-up box refit: children were emitted after their parents
    # (accel/bvh.py make_node), so a reverse pass sees every child first
    child = refit.child.reshape(-1, 8)
    m_nodes = child.shape[0]
    boxes = scene_data.tris.bvh_boxes.cpu().numpy().copy()
    node_lo = np.zeros((m_nodes, 3), np.float32)
    node_hi = np.zeros((m_nodes, 3), np.float32)
    for nid in range(m_nodes - 1, -1, -1):
        t_lo = np.full(3, 1e30, np.float32)
        t_hi = np.full(3, -1e30, np.float32)
        for k in range(8):
            cid = child[nid, k]
            if cid < 0:
                b_lo, b_hi = lo_w[-cid - 1], hi_w[-cid - 1]
            elif cid == 0:  # empty slot (the root is never a child)
                continue
            else:
                b_lo, b_hi = node_lo[cid], node_hi[cid]
            boxes[nid * 8 + k, 0:3] = b_lo
            boxes[nid * 8 + k, 3:6] = b_hi
            if b_hi[0] < 1e30:
                t_lo = np.minimum(t_lo, b_lo)
                t_hi = np.maximum(t_hi, b_hi)
        if t_lo[0] > t_hi[0]:
            t_lo = np.full(3, _NEVER, np.float32)
            t_hi = np.full(3, _NEVER, np.float32)
        node_lo[nid] = t_lo
        node_hi[nid] = t_hi

    dev = scene_data.tris.packed.device
    tris = replace(
        scene_data.tris,
        inst_w2o=torch.from_numpy(w2o).to(dev),
        inst_packed=torch.from_numpy(inst_packed).to(dev),
        bvh_boxes=torch.from_numpy(boxes).to(dev),
    )
    return replace(scene_data, tris=tris)


def _world_transforms(scene) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(I,3,4) transforms, (I,3,3) normal matrices, (I,) visibility."""
    xs, ns, vis = [], [], []
    for ins in scene.shape_instances:
        m = np.asarray(ins.transform.matrix, np.float32)
        xs.append(m[:3, :4])
        ns.append(np.linalg.inv(m[:3, :3]).T.astype(np.float32))
        vis.append(0.0 if getattr(ins, "visibility_mask", 255) == 0 else 1.0)
    if not xs:
        return (
            np.zeros((1, 3, 4), np.float32),
            np.zeros((1, 3, 3), np.float32),
            np.zeros(1, np.float32),
        )
    return np.stack(xs), np.stack(ns), np.asarray(vis, np.float32)


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(T,3,3) x (T,3) -> (T,3), each component summed left to right."""
    return (m[:, :, 0] * v[:, 0:1] + m[:, :, 1] * v[:, 1:2]) + m[:, :, 2] * v[:, 2:3]


def _norm(v: torch.Tensor) -> torch.Tensor:
    """(T,3) -> (T,1) Euclidean length (on the CPU this rounds as the
    reference's jnp.linalg.norm does, bit for bit)."""
    return torch.linalg.vector_norm(v, dim=1, keepdim=True)


def _refit_device(
    scene_data: SceneData,
    unique_rows: torch.Tensor,
    u_row: torch.Tensor,
    tri_inst: torch.Tensor,
    tri_valid: torch.Tensor,
    slot_kind: torch.Tensor,
    slot_ref: torch.Tensor,
    em_tri_row: torch.Tensor,
    em_base_weight: torch.Tensor,
    em_sphere_rows: torch.Tensor,   # (E, 6) center(3), radius, area, weight
    flip_sign: torch.Tensor,        # (I,) +-1
    xf: torch.Tensor,               # (I, 3, 4)
    nxf: torch.Tensor,              # (I, 3, 3)
    visible: torch.Tensor,          # (I,)
    sph_attrs: torch.Tensor,        # (S, SPH_COLS) host-recomputed
    sph_o2w: torch.Tensor,
    sph_w2o: torch.Tensor,
    tcl: int,
    depth: int,
    n_area: int,
    emitter_num: int,
    chunk: int = 64,
) -> SceneData:
    """The baked refit on the tables' device: the reference's
    _refit_device, step for step."""
    tris = scene_data.tris
    t_pad = tris.packed.shape[0]
    uidx = u_row.long()
    iidx = tri_inst.long()

    rows = unique_rows[uidx]               # (T, 18)
    a = xf[iidx]                           # (T, 3, 4)
    nmat = nxf[iidx]                       # (T, 3, 3)
    vis = visible[iidx][:, None]           # (T, 1)
    p0 = _matvec(a[:, :, :3], rows[:, 0:3]) + a[:, :, 3]
    e1 = _matvec(a[:, :, :3], rows[:, 3:6]) * vis
    e2 = _matvec(a[:, :, :3], rows[:, 6:9]) * vis

    def xnorm(n):
        w = _matvec(nmat, n)
        return w / torch.clamp(_norm(w), min=1e-20)

    fs = flip_sign[iidx][:, None]
    n0 = xnorm(rows[:, 9:12]) * fs
    n1 = xnorm(rows[:, 12:15]) * fs
    n2 = xnorm(rows[:, 15:18]) * fs

    # padding rows map to (instance 0, unique row 0): zero them so they
    # stay degenerate exactly like the host flatten's padding
    vmask = tri_valid[:, None]
    p0, e1, e2, n0, n1, n2 = (torch.where(vmask, x, 0.0) for x in (p0, e1, e2, n0, n1, n2))

    packed = torch.cat([p0, e1, e2, torch.zeros_like(p0)], dim=1)
    attrs = tris.attrs.clone()
    attrs[:, TRI_N0] = n0
    attrs[:, TRI_N1] = n1
    attrs[:, TRI_N2] = n2
    # keep the barycentric mirror in sync (flatten/types.py TRI_P0)
    attrs[:, 17:26] = packed[:, 0:9]

    # --- boxes -------------------------------------------------------------
    p1w = p0 + e1
    p2w = p0 + e2
    lo = torch.minimum(torch.minimum(p0, p1w), p2w)
    hi = torch.maximum(torch.maximum(p0, p1w), p2w)
    lo = torch.where(vmask, lo, 1e30)
    hi = torch.where(vmask, hi, -1e30)

    n_chunks = t_pad // chunk
    chunk_boxes = torch.cat([
        lo.reshape(n_chunks, chunk, 3).amin(dim=1),
        hi.reshape(n_chunks, chunk, 3).amax(dim=1),
        torch.zeros((n_chunks, 2), dtype=torch.float32, device=lo.device),
    ], dim=1)

    if tris.bvh_child.shape[0] > 8 or depth > 0:
        n_leaves = t_pad // tcl
        leaf_lo = lo.reshape(n_leaves, tcl, 3).amin(dim=1)
        leaf_hi = hi.reshape(n_leaves, tcl, 3).amax(dim=1)
        # never-boxes for all-padding leaves (see accel/bvh.py)
        empty_leaf = (leaf_lo[:, 0] > leaf_hi[:, 0])[:, None]
        leaf_lo = torch.where(empty_leaf, 1e30, leaf_lo)
        leaf_hi = torch.where(empty_leaf, 1e30, leaf_hi)

        m8 = slot_kind.shape[0]
        node_lo = torch.full((m8 // 8, 3), 1e30, dtype=torch.float32, device=lo.device)
        node_hi = torch.full((m8 // 8, 3), 1e30, dtype=torch.float32, device=lo.device)
        # slot_ref holds leaf or node ids: clamp each to its own table, as
        # the reference's gathers clamp (the other branch is discarded)
        ref = torch.clamp(slot_ref, min=0).long()
        lref = torch.clamp(ref, max=n_leaves - 1)
        nref = torch.clamp(ref, max=m8 // 8 - 1)
        is_leaf = (slot_kind == 1)[:, None]
        is_node = (slot_kind == 2)[:, None]
        for _ in range(depth):
            s_lo = torch.where(is_leaf, leaf_lo[lref], torch.where(is_node, node_lo[nref], 1e30))
            s_hi = torch.where(is_leaf, leaf_hi[lref], torch.where(is_node, node_hi[nref], -1e30))
            grp_lo = s_lo.reshape(-1, 8, 3)
            grp_hi = s_hi.reshape(-1, 8, 3)
            any_real = (grp_lo[:, :, 0] <= grp_hi[:, :, 0]).any(dim=1)[:, None]
            node_lo = torch.where(any_real, grp_lo.amin(dim=1), 1e30)
            node_hi = torch.where(any_real, grp_hi.amax(dim=1), 1e30)
        s_lo = torch.where(is_leaf, leaf_lo[lref], torch.where(is_node, node_lo[nref], 1e30))
        s_hi = torch.where(is_leaf, leaf_hi[lref], torch.where(is_node, node_hi[nref], 1e30))
        # degenerate slots become never-hit point boxes at 1e30
        bad = (s_lo[:, 0] > s_hi[:, 0])[:, None]
        s_hi = torch.where(bad, 1e30, s_hi)
        s_lo = torch.where(bad, 1e30, s_lo)
        bvh_boxes = torch.cat(
            [s_lo, s_hi, torch.zeros((m8, 2), dtype=torch.float32, device=lo.device)], dim=1)
    else:
        bvh_boxes = tris.bvh_boxes
    # the sub-leaf groups keep their rows; their boxes follow the rows
    subleaf_boxes = (baked_subleaf_boxes(packed, tris.subleaf_rows, tcl)
                     if tris.subleaf_rows.shape[0] == t_pad else tris.subleaf_boxes)
    # and so do the chunk sweep's (a tree's tables hold a placeholder)
    sweep = sweep_boxes(packed) if tris.sweep_boxes.shape[0] else tris.sweep_boxes

    new_tris = replace(
        tris,
        packed=packed,
        attrs=attrs,
        chunk_boxes=chunk_boxes,
        sweep_boxes=sweep,
        bvh_boxes=bvh_boxes,
        subleaf_boxes=subleaf_boxes,
    )

    # --- emitters ------------------------------------------------------------
    em = scene_data.emitters
    new_em = em
    if n_area > 0:
        t_e = torch.clamp(em_tri_row, min=0).long()
        is_tri = em_tri_row >= 0
        v0 = p0[t_e]
        v1 = p1w[t_e]
        v2 = p2w[t_e]
        cr = torch.linalg.cross(v1 - v0, v2 - v0, dim=1)
        tri_area = 0.5 * _norm(cr)[:, 0]
        tn0 = n0[t_e]
        tn1 = n1[t_e]
        tn2 = n2[t_e]
        tri_w = em_base_weight * tri_area * visible[iidx[t_e]]

        area = torch.where(is_tri, tri_area, em_sphere_rows[:, 4])
        weight = torch.where(is_tri, tri_w, em_sphere_rows[:, 5])
        radius = torch.where(is_tri, 0.0, em_sphere_rows[:, 3])
        v0p = torch.where(is_tri[:, None], v0, em_sphere_rows[:, 0:3])
        keep = em.etype >= 2  # delta lights: static rows
        v0p = torch.where(keep[:, None], em.v0p, v0p)
        area = torch.where(keep, em.area, area)
        radius = torch.where(keep, em.radius, radius)
        weight = torch.where(keep, em_base_weight, weight)

        wsum = torch.clamp(weight[:n_area].sum(), min=1e-30)
        select_prob = weight / wsum * (n_area / max(emitter_num, 1))
        select_cdf = torch.cumsum(select_prob, dim=0)

        moved = (is_tri & ~keep)[:, None]
        v1p = torch.where(moved, v1, em.v1p)
        v2p = torch.where(moved, v2, em.v2p)
        v0n = torch.where(moved, tn0, em.v0n)
        v1n = torch.where(moved, tn1, em.v1n)
        v2n = torch.where(moved, tn2, em.v2n)
        packed_em = em.packed.clone()
        packed_em[:, EM_V0P] = v0p
        packed_em[:, EM_V1P] = v1p
        packed_em[:, EM_V2P] = v2p
        packed_em[:, EM_V0N] = v0n
        packed_em[:, EM_V1N] = v1n
        packed_em[:, EM_V2N] = v2n
        packed_em[:, EM_RADIUS] = radius
        packed_em[:, EM_AREA] = area
        packed_em[:, EM_SELECT_PROB] = select_prob

        new_em = replace(
            em, packed=packed_em, v0p=v0p, v1p=v1p, v2p=v2p, v0n=v0n, v1n=v1n,
            v2n=v2n, radius=radius, area=area, select_prob=select_prob,
            select_cdf=select_cdf,
        )

    new_spheres = replace(
        scene_data.spheres, attrs=sph_attrs, o2w=sph_o2w, w2o=sph_w2o
    )
    return replace(
        scene_data, tris=new_tris, emitters=new_em, spheres=new_spheres
    )


def refit_scene(scene_data: SceneData, refit, scene) -> SceneData:
    """Host entry: recompute the per-instance transforms (O(instances)),
    upload them and refit on the tables' device. Instanced scenes go to
    refit_instanced (object-space tables are static; only matrices and
    boxes move)."""
    if isinstance(refit, InstRefitData):
        return refit_instanced(scene_data, refit, scene)
    if not isinstance(refit, RefitData):
        raise TypeError(f"refit_scene: expected RefitData or InstRefitData, got {type(refit)}")
    xf, nxf, visible = _world_transforms(scene)

    # spheres + sphere emitters are few: recompute their rows on host
    s_count = refit.sphere_inst.shape[0]
    sph_attrs = scene_data.spheres.attrs.cpu().numpy().copy()
    sph_o2w = scene_data.spheres.o2w.cpu().numpy().copy()
    sph_w2o = scene_data.spheres.w2o.cpu().numpy().copy()
    sph_emit = scene_data.spheres.emitter_id.cpu().numpy()
    e_count = refit.em_tri_row.shape[0]
    em_sphere_rows = np.zeros((max(e_count, 1), 6), np.float32)
    for si in range(s_count):
        inst = int(refit.sphere_inst[si])
        if inst < 0:
            continue
        ins = scene.shape_instances[inst]
        m = np.asarray(ins.transform.matrix, np.float32)
        hidden = getattr(ins, "visibility_mask", 255) == 0
        if hidden:
            sph_o2w[si] = 0.0
            sph_w2o[si] = 0.0
        else:
            sph_o2w[si] = m[:3, :4]
            sph_w2o[si] = np.linalg.inv(m)[:3, :4]
        sph_attrs[si, 0:12] = sph_w2o[si].reshape(12)
        eid = int(sph_emit[si])
        if eid >= 0:
            c = m[:3, 3]
            p = (m @ np.array([1.0, 0, 0, 1.0], np.float32))[:3]
            radius = float(np.linalg.norm(c - p))
            area = 4.0 * np.pi * radius * radius
            w = 0.0 if hidden else float(refit.em_base_weight[eid]) * area
            em_sphere_rows[eid] = [*c, radius, area, w]

    dev = scene_data.tris.packed.device

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return _refit_device(
        scene_data,
        up(refit.unique_rows), up(refit.u_row), up(refit.tri_inst), up(refit.tri_valid),
        up(refit.slot_kind), up(refit.slot_ref), up(refit.em_tri_row),
        up(refit.em_base_weight), up(em_sphere_rows), up(refit.flip_sign),
        up(xf), up(nxf), up(visible), up(sph_attrs), up(sph_o2w), up(sph_w2o),
        tcl=refit.tcl, depth=refit.depth, n_area=refit.n_area,
        emitter_num=refit.emitter_num,
    )
