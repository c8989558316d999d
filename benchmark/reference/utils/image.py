"""Image IO: EXR (scanline, NONE/ZIPS/ZIP), Radiance HDR (RGBE), and LDR.

The reference loads textures with stb (LDR, gamma-2.2 decoded to linear,
util/texture.cpp:112-115), stb-hdr and tinyexr, and saves screenshots as
HDR/EXR (util/texture.cpp:13-85). There is no OpenEXR binding in this
environment, so the EXR codec here is implemented from the file-format
spec in pure numpy (half/float channels, NONE/ZIPS/ZIP compression).

All loaders return float32 RGBA arrays of shape (h, w, 4), linear light,
row 0 = top (file order).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

# --------------------------------------------------------------------------
# EXR
# --------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _exr_unpredict_deinterleave(data: bytes) -> bytes:
    # Undo delta predictor: d[i] = d[i-1] + t[i] - 128, d[0] = t[0].
    t = np.frombuffer(data, np.uint8).astype(np.int64)
    d = (t[0] + np.concatenate([[0], np.cumsum(t[1:] - 128)])).astype(np.uint8)
    # Deinterleave two halves.
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _exr_interleave_predict(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int64)
    t = np.empty(n, np.int64)
    t[0] = d[0]
    t[1:] = d[1:] - d[:-1] + 128
    return (t & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str | Path) -> np.ndarray:
    buf = Path(path).read_bytes()
    magic, version = struct.unpack_from("<iI", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    channels: list[tuple[str, int]] = []
    compression = _COMP_NONE
    data_window = (0, 0, 0, 0)
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            break
        atype, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cname, cp = _read_cstr(payload, cp)
                (ptype,) = struct.unpack_from("<i", payload, cp)
                cp += 16  # type + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")
    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[compression]
    nblocks = (h + lpb - 1) // lpb

    # Channels are stored sorted by name within each scanline.
    chan_sorted = sorted(channels, key=lambda c: c[0])
    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32, _PT_UINT: np.uint32}
    sizes = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}

    offsets = struct.unpack_from(f"<{nblocks}Q", buf, pos)
    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}

    for off in offsets:
        y, dsize = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8 : off + 8 + dsize]
        y0 = y - ymin
        nlines = min(lpb, h - y0)
        expect = nlines * sum(w * sizes[t] for _, t in channels)
        if compression in (_COMP_ZIP, _COMP_ZIPS) and dsize < expect:
            raw = _exr_unpredict_deinterleave(zlib.decompress(raw))
        cp = 0
        for line in range(nlines):
            for cname, ptype in chan_sorted:
                nbytes = w * sizes[ptype]
                vals = np.frombuffer(raw[cp : cp + nbytes], dtypes[ptype])
                planes[cname][y0 + line] = vals.astype(np.float32)
                cp += nbytes

    out = np.zeros((h, w, 4), np.float32)
    out[..., 3] = 1.0
    names = {c for c, _ in channels}
    for i, key in enumerate("RGBA"):
        if key in names:
            out[..., i] = planes[key]
    if not names & {"R", "G", "B"}:  # luminance-only
        first = chan_sorted[0][0]
        out[..., 0] = out[..., 1] = out[..., 2] = planes[first]
    return out


def write_exr(path: str | Path, img: np.ndarray, compress: bool = True) -> None:
    """Write (h, w, 3|4) float32 as scanline EXR (ZIPS or NONE)."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("write_exr expects (h, w, 3|4)")
    h, w, nc = img.shape
    names = ["B", "G", "R"] if nc == 3 else ["A", "B", "G", "R"]
    chan_data = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if nc == 4:
        chan_data["A"] = img[..., 3]

    def attr(name: str, atype: str, payload: bytes) -> bytes:
        return (
            name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for n in names:  # alphabetical already
        chlist += n.encode() + b"\x00" + struct.pack("<i", _PT_FLOAT)
        chlist += b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\x00"

    comp = _COMP_ZIPS if compress else _COMP_NONE
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            attr("channels", "chlist", chlist),
            attr("compression", "compression", bytes([comp])),
            attr("dataWindow", "box2i", box),
            attr("displayWindow", "box2i", box),
            attr("lineOrder", "lineOrder", b"\x00"),
            attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
            attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0)),
            attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )

    chunks = []
    for y in range(h):
        raw = b"".join(chan_data[n][y].astype("<f4").tobytes() for n in names)
        if compress:
            z = zlib.compress(_exr_interleave_predict(raw))
            data = z if len(z) < len(raw) else raw
        else:
            data = raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)

    base = 8 + len(header) + 8 * h
    offsets, acc = [], base
    for c in chunks:
        offsets.append(acc)
        acc += len(c)

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", _EXR_MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for c in chunks:
            f.write(c)


# --------------------------------------------------------------------------
# Radiance HDR (RGBE)
# --------------------------------------------------------------------------

def read_hdr(path: str | Path) -> np.ndarray:
    buf = Path(path).read_bytes()
    if not (buf.startswith(b"#?RADIANCE") or buf.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = buf.index(b"\n\n") + 2
    eol = buf.index(b"\n", pos)
    dims = buf[pos:eol].decode().split()
    if dims[0] != "-Y" or dims[2] != "+X":
        raise ValueError(f"{path}: unsupported HDR orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    pos = eol + 1

    rgbe = np.zeros((h, w, 4), np.uint8)
    data = np.frombuffer(buf, np.uint8)
    for y in range(h):
        if w < 8 or w > 0x7FFF or not (
            data[pos] == 2 and data[pos + 1] == 2 and (data[pos + 2] << 8 | data[pos + 3]) == w
        ):
            # Flat (old-format) scanline.
            row = data[pos : pos + w * 4].reshape(w, 4)
            rgbe[y] = row
            pos += w * 4
            continue
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                count = int(data[pos]); pos += 1
                if count > 128:  # run
                    rgbe[y, x : x + count - 128, c] = data[pos]
                    pos += 1
                    x += count - 128
                else:  # literal
                    rgbe[y, x : x + count, c] = data[pos : pos + count]
                    pos += count
                    x += count

    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    out = np.ones((h, w, 4), np.float32)
    out[..., :3] = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return out


def write_hdr(path: str | Path, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    rgb = np.maximum(img[..., :3], 0.0)
    maxc = rgb.max(axis=-1)
    e = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    m, e_nz = np.frexp(maxc[nz])
    e[nz] = e_nz
    scale = np.zeros((h, w), np.float32)
    scale[nz] = m * 256.0 / maxc[nz]
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[nz, 3] = (e[nz] + 128).astype(np.uint8)

    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if 8 <= w <= 0x7FFF:
            # New-RLE encoding with literal runs only (chunks of <=128).
            for y in range(h):
                f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
                for c in range(4):
                    col = rgbe[y, :, c].tobytes()
                    for x in range(0, w, 128):
                        chunk = col[x : x + 128]
                        f.write(bytes([len(chunk)]) + chunk)
        else:
            f.write(rgbe.tobytes())


# --------------------------------------------------------------------------
# Unified interface
# --------------------------------------------------------------------------

LDR_GAMMA = 2.2  # stb LDR decode gamma (util/texture.cpp:112-115)


def load_image(path: str | Path) -> np.ndarray:
    """Load any supported image as linear float32 RGBA (h, w, 4)."""
    p = Path(path)
    suffix = p.suffix.lower()
    if suffix == ".exr":
        return read_exr(p)
    if suffix == ".hdr":
        return read_hdr(p)
    from PIL import Image

    with Image.open(p) as im:
        im = im.convert("RGBA")
        arr = np.asarray(im, np.float32) / 255.0
    out = arr.copy()
    out[..., :3] = arr[..., :3] ** LDR_GAMMA  # gamma decode to linear
    return out


def save_image(path: str | Path, img: np.ndarray) -> None:
    """Save float32 (h, w, 3|4); format from extension (EXR/HDR/PNG...)."""
    p = Path(path)
    suffix = p.suffix.lower()
    if img.dtype == np.uint8:
        # display-encoded bytes from the u8 fetch path: LDR formats save
        # directly; HDR formats get gamma inverted back to linear-ish
        # values (the baked ACES tonemap is not invertible, so the
        # result is display-referred linear, not scene radiance)
        ch = img if img.ndim == 2 else img[..., :3]
        if suffix not in (".exr", ".hdr"):
            from PIL import Image

            Image.fromarray(ch).save(p)
            return
        img = (img.astype(np.float32) / 255.0) ** LDR_GAMMA
    if suffix == ".exr":
        write_exr(p, img)
        return
    if suffix == ".hdr":
        write_hdr(p, img)
        return
    from PIL import Image

    ldr = np.clip(img[..., :3], 0.0, 1.0) ** (1.0 / LDR_GAMMA)
    Image.fromarray((ldr * 255.0 + 0.5).astype(np.uint8)).save(p)
