"""Native PLY and glTF/GLB mesh readers.

The reference imports meshes through assimp (resource/shape.cpp:219-278,
aiProcess_Triangulate, single-mesh). This build reads OBJ natively
(scene/shapes.py) and adds the two most common interchange formats here,
with no third-party dependencies:

* PLY: ascii and binary_little_endian, vertex properties
  x/y/z (+ nx/ny/nz, + s/t | u/v | texture_u/texture_v), face
  vertex-index lists (fan-triangulated like the OBJ path);
* glTF 2.0: .gltf (JSON + external/embedded buffers) and .glb
  containers; POSITION/NORMAL/TEXCOORD_0 + indices accessors, all
  triangle primitives of every mesh merged into one soup with node
  world transforms applied (exceeds the reference's single-mesh limit);
* STL: binary (84-byte header + 50-byte facet records) and ascii,
  disambiguated by the record-count size check (binary files commonly
  start with "solid" too); facet normals kept per-vertex;
* COLLADA (.dae): library_geometries <triangles>/<polylist> with
  VERTEX/NORMAL/TEXCOORD inputs at per-input offsets, polylist
  fan-triangulation, node world transforms from library_visual_scenes
  (<matrix>/<translate>/<rotate>/<scale>), and asset <up_axis>
  conversion to Y-up.
"""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str | Path):
    """Returns (positions (v,3) f32, normals|None, texcoords|None,
    indices (f,3) u32)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_kind, name, dtypes...)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur[2].append(("list", tok[4], _PLY_DTYPES[tok[2]],
                                   _PLY_DTYPES[tok[3]]))
                else:
                    cur[2].append(("scalar", tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"{path}: unsupported PLY format {fmt}")

        verts = {}
        faces = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    cols = [p[1] for p in props]
                    arr = np.asarray(rows, np.float64)
                    for j, cname in enumerate(cols):
                        verts[cname] = arr[:, j]
                elif name == "face":
                    for row in rows:
                        k = int(row[0])
                        ids = [int(v) for v in row[1:1 + k]]
                        for t in range(1, k - 1):
                            faces.append((ids[0], ids[t], ids[t + 1]))
                # other elements ignored
            else:
                if name == "vertex" and all(p[0] == "scalar" for p in props):
                    dt = np.dtype([(p[1], "<" + p[2]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * count), dt)
                    for p in props:
                        verts[p[1]] = data[p[1]].astype(np.float64)
                elif name == "face":
                    # variable-length lists -> parse sequentially
                    (kind, _, cnt_t, idx_t) = props[0]
                    cnt_dt = np.dtype("<" + cnt_t)
                    idx_dt = np.dtype("<" + idx_t)
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                        ids = np.frombuffer(f.read(idx_dt.itemsize * k), idx_dt)
                        for t in range(1, k - 1):
                            faces.append((int(ids[0]), int(ids[t]), int(ids[t + 1])))
                else:
                    # skip unknown fixed-size elements
                    size = sum(np.dtype("<" + p[2]).itemsize for p in props
                               if p[0] == "scalar")
                    f.read(size * count)

    pos = np.stack([verts["x"], verts["y"], verts["z"]], 1).astype(np.float32)
    normals = None
    if all(k in verts for k in ("nx", "ny", "nz")):
        normals = np.stack(
            [verts["nx"], verts["ny"], verts["nz"]], 1
        ).astype(np.float32)
    uv = None
    for a, b in (("s", "t"), ("u", "v"), ("texture_u", "texture_v")):
        if a in verts and b in verts:
            uv = np.stack([verts[a], verts[b]], 1).astype(np.float32)
            break
    indices = np.asarray(faces, np.uint32).reshape(-1, 3)
    return pos, normals, uv, indices


_GLTF_COMPONENT = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_GLTF_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _gltf_buffers(doc, path: Path, glb_bin: bytes | None):
    bufs = []
    for b in doc.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            bufs.append((path.parent / uri).read_bytes())
    return bufs


def _gltf_accessor(doc, bufs, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _GLTF_COMPONENT[acc["componentType"]]
    ncomp = _GLTF_NCOMP[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp
    stride = view.get("byteStride") or itemsize
    base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    raw = bufs[view["buffer"]]
    if stride == itemsize:
        arr = np.frombuffer(raw, dtype, count * ncomp, base)
        return arr.reshape(count, ncomp)
    rows = [
        np.frombuffer(raw, dtype, ncomp, base + i * stride) for i in range(count)
    ]
    return np.stack(rows)


def _node_world_transforms(doc):
    """World 4x4 per node (column-vector convention)."""
    nodes = doc.get("nodes", [])
    world = [None] * len(nodes)

    def local(nd):
        if "matrix" in nd:
            return np.asarray(nd["matrix"], np.float64).reshape(4, 4).T
        m = np.eye(4)
        if "scale" in nd:
            m = m @ np.diag(list(nd["scale"]) + [1.0])
        if "rotation" in nd:
            x, y, z, w = nd["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            rm = np.eye(4)
            rm[:3, :3] = r
            m = rm @ m
        if "translation" in nd:
            tm = np.eye(4)
            tm[:3, 3] = nd["translation"]
            m = tm @ m
        return m

    def walk(i, parent):
        world[i] = parent @ local(nodes[i])
        for c in nodes[i].get("children", []):
            walk(c, world[i])

    scenes = doc.get("scenes", [{}])
    roots = scenes[doc.get("scene", 0)].get("nodes", range(len(nodes)))
    for r in roots:
        walk(r, np.eye(4))
    for i in range(len(nodes)):
        if world[i] is None:
            world[i] = np.eye(4)
    return world


def load_gltf(path: str | Path):
    """Returns (positions, normals|None, texcoords|None, indices) with
    all triangle primitives merged in node world space."""
    path = Path(path)
    glb_bin = None
    if path.suffix.lower() == ".glb":
        raw = path.read_bytes()
        magic, _version, _length = struct.unpack_from("<III", raw, 0)
        if magic != 0x46546C67:
            raise ValueError(f"{path}: bad GLB magic")
        off = 12
        doc = None
        while off < len(raw):
            clen, ctype = struct.unpack_from("<II", raw, off)
            chunk = raw[off + 8 : off + 8 + clen]
            if ctype == 0x4E4F534A:  # JSON
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # BIN
                glb_bin = chunk
            off += 8 + clen
        if doc is None:
            raise ValueError(f"{path}: GLB without JSON chunk")
    else:
        doc = json.loads(path.read_text())
    bufs = _gltf_buffers(doc, path, glb_bin)
    world = _node_world_transforms(doc)

    all_pos, all_n, all_uv, all_idx = [], [], [], []
    base = 0
    has_n = has_uv = True
    mesh_nodes = [
        (nd["mesh"], world[i])
        for i, nd in enumerate(doc.get("nodes", []))
        if "mesh" in nd
    ] or [(mi, np.eye(4)) for mi in range(len(doc.get("meshes", [])))]
    for mesh_idx, m in mesh_nodes:
        mesh = doc["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            attrs = prim["attributes"]
            pos = _gltf_accessor(doc, bufs, attrs["POSITION"]).astype(np.float64)
            pos = pos @ m[:3, :3].T + m[:3, 3]
            n = pos.shape[0]
            all_pos.append(pos.astype(np.float32))
            if "NORMAL" in attrs:
                nrm = _gltf_accessor(doc, bufs, attrs["NORMAL"]).astype(np.float64)
                inv_t = np.linalg.inv(m[:3, :3]).T
                nrm = nrm @ inv_t.T
                nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
                all_n.append(nrm.astype(np.float32))
            else:
                has_n = False
                all_n.append(np.zeros((n, 3), np.float32))
            if "TEXCOORD_0" in attrs:
                all_uv.append(
                    _gltf_accessor(doc, bufs, attrs["TEXCOORD_0"]).astype(np.float32)
                )
            else:
                has_uv = False
                all_uv.append(np.zeros((n, 2), np.float32))
            if "indices" in prim:
                idx = _gltf_accessor(doc, bufs, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(n, dtype=np.uint32)
            all_idx.append(idx.astype(np.uint32).reshape(-1, 3) + base)
            base += n

    if not all_pos:
        raise ValueError(f"{path}: no triangle primitives")
    pos = np.concatenate(all_pos)
    return (
        pos,
        np.concatenate(all_n) if has_n else None,
        np.concatenate(all_uv) if has_uv else None,
        np.concatenate(all_idx),
    )

def load_stl(path: str | Path):
    """Returns (positions (v,3) f32, normals (v,3) f32, None, indices).

    Vertices are NOT deduplicated (STL is a facet soup); the facet
    normal is replicated to its 3 vertices. Binary vs ascii is decided
    by the 84 + 50*count size identity, not the "solid" prefix (many
    binary exporters write it anyway)."""
    path = Path(path)
    raw = path.read_bytes()
    is_binary = False
    if len(raw) >= 84:
        (count,) = struct.unpack_from("<I", raw, 80)
        if len(raw) == 84 + 50 * count:
            is_binary = True
    if is_binary:
        rec = np.frombuffer(
            raw[84:84 + 50 * count],
            dtype=np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)),
                            ("attr", "<u2")]),
        )
        pos = rec["v"].reshape(-1, 3).astype(np.float32)
        nrm = np.repeat(rec["n"], 3, axis=0).astype(np.float32)
    else:
        verts, norms = [], []
        cur_n = (0.0, 0.0, 0.0)
        for line in raw.decode("ascii", "replace").splitlines():
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "facet" and len(tok) >= 5:
                cur_n = (float(tok[2]), float(tok[3]), float(tok[4]))
            elif tok[0] == "vertex":
                verts.append((float(tok[1]), float(tok[2]), float(tok[3])))
                norms.append(cur_n)
        if not verts or len(verts) % 3:
            raise ValueError(f"{path}: malformed ascii STL")
        pos = np.asarray(verts, np.float32)
        nrm = np.asarray(norms, np.float32)
    # zero facet normals (allowed by spec) -> geometric normals
    bad = np.linalg.norm(nrm, axis=1) < 1e-12
    if bad.any():
        tri = pos.reshape(-1, 3, 3)
        gn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
        nrm = np.where(bad[:, None], np.repeat(gn, 3, axis=0), nrm)
    idx = np.arange(pos.shape[0], dtype=np.uint32).reshape(-1, 3)
    return pos, nrm, None, idx


def _dae_local(name: str) -> str:
    """Strip the XML namespace from a tag."""
    return name.rsplit("}", 1)[-1]


def _dae_node_matrix(node) -> np.ndarray:
    m = np.eye(4)
    for ch in node:
        tag = _dae_local(ch.tag)
        if tag == "matrix":
            vals = np.asarray([float(x) for x in ch.text.split()], np.float64)
            m = m @ vals.reshape(4, 4)
        elif tag == "translate":
            v = [float(x) for x in ch.text.split()]
            t = np.eye(4)
            t[:3, 3] = v
            m = m @ t
        elif tag == "rotate":
            x, y, z, deg = [float(v) for v in ch.text.split()]
            a = np.deg2rad(deg)
            axis = np.asarray([x, y, z], np.float64)
            axis /= max(np.linalg.norm(axis), 1e-20)
            c, s = np.cos(a), np.sin(a)
            K = np.array([
                [0, -axis[2], axis[1]],
                [axis[2], 0, -axis[0]],
                [-axis[1], axis[0], 0],
            ])
            r = np.eye(4)
            r[:3, :3] = np.eye(3) * c + s * K + (1 - c) * np.outer(axis, axis)
            m = m @ r
        elif tag == "scale":
            v = [float(x) for x in ch.text.split()]
            sm = np.eye(4)
            sm[0, 0], sm[1, 1], sm[2, 2] = v
            m = m @ sm
    return m

def load_dae(path: str | Path):
    """Minimal COLLADA reader. Returns (positions, normals|None,
    texcoords|None, indices), all geometry instances merged in node
    world space and converted to Y-up.

    Covers the common exporter subset (reference parity: assimp's DAE
    importer, resource/shape.cpp:219-278): <triangles> and <polylist>
    primitives, VERTEX/NORMAL/TEXCOORD inputs with per-input offsets,
    <instance_geometry> under arbitrarily nested visual-scene nodes."""
    import xml.etree.ElementTree as ET

    path = Path(path)
    root = ET.parse(path).getroot()

    up = "Y_UP"
    for el in root.iter():
        if _dae_local(el.tag) == "up_axis" and el.text:
            up = el.text.strip()
    if up == "Z_UP":  # (x,y,z) -> (x,z,-y)
        up_m = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                         [0, 0, 0, 1]], np.float64)
    elif up == "X_UP":  # (x,y,z) -> (-y,x,z)
        up_m = np.array([[0, -1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0],
                         [0, 0, 0, 1]], np.float64)
    else:
        up_m = np.eye(4)

    # geometry id -> list of (pos (k,3), nrm|None (k,3), uv|None (k,2))
    # expanded triangle soups (indices resolved per-primitive)
    geoms = {}
    for geo in root.iter():
        if _dae_local(geo.tag) != "geometry":
            continue
        gid = geo.get("id")
        prims = []
        for mesh in geo:
            if _dae_local(mesh.tag) != "mesh":
                continue
            sources = {}  # id -> (flat float array, accessor stride)
            vertices_map = {}
            for el in mesh:
                tag = _dae_local(el.tag)
                if tag == "source":
                    arr, stride = None, 3
                    for sub in el.iter():
                        stag = _dae_local(sub.tag)
                        if stag == "float_array" and sub.text:
                            arr = np.asarray(
                                [float(x) for x in sub.text.split()],
                                np.float64,
                            )
                        elif stag == "accessor":
                            stride = int(sub.get("stride", "3"))
                    if arr is not None:
                        sources[el.get("id")] = (arr, stride)
                elif tag == "vertices":
                    for inp in el:
                        if (_dae_local(inp.tag) == "input"
                                and inp.get("semantic") == "POSITION"):
                            vertices_map[el.get("id")] = \
                                inp.get("source").lstrip("#")
            for el in mesh:
                tag = _dae_local(el.tag)
                if tag not in ("triangles", "polylist"):
                    continue
                inputs = []  # (semantic, source id, offset)
                vcount = None
                pdata = None
                for ch in el:
                    ctag = _dae_local(ch.tag)
                    if ctag == "input":
                        src = ch.get("source").lstrip("#")
                        src = vertices_map.get(src, src)
                        inputs.append((ch.get("semantic"), src,
                                       int(ch.get("offset", "0"))))
                    elif ctag == "vcount" and ch.text:
                        vcount = [int(x) for x in ch.text.split()]
                    elif ctag == "p" and ch.text:
                        pdata = np.asarray(
                            [int(x) for x in ch.text.split()], np.int64
                        )
                if pdata is None or not inputs:
                    continue
                stride = max(off for _, _, off in inputs) + 1
                pdata = pdata.reshape(-1, stride)
                if tag == "polylist" and vcount is not None:
                    # fan-triangulate: corner row index list per face
                    rows = []
                    base = 0
                    for k in vcount:
                        for t in range(1, k - 1):
                            rows += [base, base + t, base + t + 1]
                        base += k
                    pdata = pdata[rows]
                pos = nrm = uv = None
                for sem, src, off in inputs:
                    ent = sources.get(src)
                    if ent is None:
                        continue
                    arr, stride = ent
                    rows2d = arr.reshape(-1, stride)
                    if sem == "VERTEX":
                        pos = rows2d[:, :3][pdata[:, off]]
                    elif sem == "NORMAL":
                        nrm = rows2d[:, :3][pdata[:, off]]
                    elif sem == "TEXCOORD" and uv is None:
                        uv = rows2d[:, :2][pdata[:, off]]
                if pos is not None:
                    prims.append((pos, nrm, uv))
        if prims:
            geoms[gid] = prims

    # visual-scene instances; a file without scenes uses identity
    instances = []  # (geometry id, world 4x4)

    def walk(node, parent_m):
        m = parent_m @ _dae_node_matrix(node)
        for ch in node:
            tag = _dae_local(ch.tag)
            if tag == "instance_geometry":
                instances.append((ch.get("url").lstrip("#"), m))
            elif tag == "node":
                walk(ch, m)

    for vs in root.iter():
        if _dae_local(vs.tag) == "visual_scene":
            for node in vs:
                if _dae_local(node.tag) == "node":
                    walk(node, np.eye(4))
    if not instances:
        instances = [(gid, np.eye(4)) for gid in geoms]

    all_pos, all_n, all_uv = [], [], []
    has_n = has_uv = True
    for gid, m in instances:
        m = up_m @ m
        inv_t = np.linalg.inv(m[:3, :3]).T
        for pos, nrm, uv in geoms.get(gid, []):
            k = pos.shape[0]
            all_pos.append((pos @ m[:3, :3].T + m[:3, 3]).astype(np.float32))
            if nrm is not None:
                w = nrm @ inv_t.T
                w /= np.maximum(np.linalg.norm(w, axis=1, keepdims=True),
                                1e-20)
                all_n.append(w.astype(np.float32))
            else:
                has_n = False
                all_n.append(np.zeros((k, 3), np.float32))
            if uv is not None:
                all_uv.append(uv.astype(np.float32))
            else:
                has_uv = False
                all_uv.append(np.zeros((k, 2), np.float32))
    if not all_pos:
        raise ValueError(f"{path}: no triangle geometry")
    pos = np.concatenate(all_pos)
    idx = np.arange(pos.shape[0], dtype=np.uint32).reshape(-1, 3)
    return (
        pos,
        np.concatenate(all_n) if has_n else None,
        np.concatenate(all_uv) if has_uv else None,
        idx,
    )
