"""Port parity: the display clients (display/client.py, display/web.py) on
the CPU.

Held against the JAX package on data/oracle_mat.xml (no frame rendered):

* the frame pump (``DisplayClient._on_frame_finished``) on the same seeded
  buffer arrays, 1-4 channels, the tone-map and gamma toggles and the
  motion preview's stride 2: the flipped uint8 image within 1 level (pow
  and the ACES quotient round differently in the two packages);
* ``pick_object`` on a 16x16 grid of canvas points: the same object, t
  within rtol 1e-6;
* ``drag_object`` translate, rotate and scale: every instance matrix
  within 1e-6;
* ``console_state``: the same keys and values, apart from the times.

Then the port's HTTP server on 127.0.0.1 (port 0) with
``System(device="cpu")`` on oracle_mat at a 16x16 film is driven through
every route of the module's docstring, as tests/test_web_display.py drives
the reference's on cornell: frames are run by the test between requests,
so each edit's effect is read deterministically, and one test runs the
render thread (``System.run(threaded=True)``) under concurrent requests.
"""

import io
import json
import re
import struct
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pupiloptixlab_tpu.passes import PTPass as JaxPTPass
from pupiloptixlab_tpu.system import System as JaxSystem
from pupiloptixlab_tpu.system.buffers import BufferFlag as JaxBufferFlag
from pupiloptixlab_tpu_torch.display.tonemap import expand_to_rgba, to_display_u8
from pupiloptixlab_tpu_torch.display.web import _encode_png
from pupiloptixlab_tpu_torch.passes import PTPass
from pupiloptixlab_tpu_torch.system import System
from pupiloptixlab_tpu_torch.system.buffers import BufferFlag
from pupiloptixlab_tpu_torch.utils.camera import Camera
from pupiloptixlab_tpu_torch.utils.image import read_exr

DATA = Path(__file__).resolve().parent.parent / "data"
SCENE = DATA / "oracle_mat.xml"
W, H = 40, 24  # probe buffers: not square, so a wrong reshape or flip shows


def _systems(with_pass: bool):
    out = []
    for system_cls, pass_cls, kw in ((JaxSystem, JaxPTPass, {}),
                                     (System, PTPass, {"device": "cpu"})):
        system = system_cls(display="web", web_port=0, **kw)
        if with_pass:
            system.add_pass(pass_cls())
        assert system.set_scene(SCENE)
        out.append(system)
    return out


@pytest.fixture(scope="module")
def pair():
    """Both packages' Systems with a PTPass after set_scene (no frame)."""
    return _systems(with_pass=True)


@pytest.fixture()
def bare():
    """Both packages' Systems without passes after set_scene, fresh per
    test (the drags edit the scene)."""
    return _systems(with_pass=False)


@pytest.mark.parametrize("channels,tone_mapping,gamma,stride", [
    (3, True, True, 1), (4, True, True, 1), (1, True, True, 1), (2, False, True, 1),
    (3, True, False, 1), (3, False, False, 1), (3, True, True, 2), (1, False, True, 2)])
def test_frame_pump_matches_reference(pair, channels, tone_mapping, gamma, stride):
    r = np.random.default_rng(channels * 10 + stride)
    arr = (r.random((W * H, channels), dtype=np.float32) ** 3 * 6.0).astype(np.float32)
    arr[0] = -0.25
    if channels == 1:
        arr = arr[:, 0]
    images = []
    for system, array, flag in ((pair[0], jnp.asarray(arr), JaxBufferFlag.ALLOW_DISPLAY),
                                (pair[1], torch.from_numpy(arr), BufferFlag.ALLOW_DISPLAY)):
        d = system.display
        system.buffers.add("probe", array, flag, W, H)
        d.select_buffer("probe")
        d.tone_mapping, d.gamma = tone_mapping, gamma
        d._preview_until = time.monotonic() + 3600.0 if stride == 2 else 0.0
        d._on_frame_finished(16.0)
        assert (d.fps, d.frame_time_ms) == (62.5, 16.0)
        images.append(d.latest_image())
    want, got = images
    assert got.dtype == np.uint8 and got.shape == want.shape == (H // stride, W // stride, 3)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    # the buffer's rows bottom-up (film row 0 = bottom), at the stride
    rgb = expand_to_rgba(torch.from_numpy(arr), W, H)[..., :3]
    np.testing.assert_array_equal(
        got, to_display_u8(rgb, tone_mapping, gamma, stride).flip(0).numpy())
    # the flip model: the next frame goes to the other slot
    pair[1].display._on_frame_finished(16.0)
    assert pair[1].display.latest_image() is not got


def test_buffer_selection_falls_back_like_the_reference(pair):
    for system in pair:
        system.display.select_buffer("no such buffer")
    names = [s.display._select_buffer().desc.name for s in pair]
    assert names[0] == names[1] == "final result"
    assert pair[1].display.buffer_names() == pair[0].display.buffer_names()


def test_pick_matches_reference(pair):
    """A 16x16 grid of canvas points (cell centres): the same object (or
    none) and t within rtol 1e-6."""
    seen = set()
    for ny in (np.arange(16) + 0.5) / 16:
        for nx in (np.arange(16) + 0.5) / 16:
            (jn, jt), (tn, tt) = (s.display.pick_object(float(nx), float(ny)) for s in pair)
            assert tn == jn, (nx, ny)
            np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=0.0)
            seen.add(tn)
    assert len(seen - {None}) >= 5, seen


@pytest.mark.parametrize("mode,dx,dy", [
    ("translate", 0.07, -0.03), ("rotate", 0.1, 0.05), ("scale", 0.0, -0.2)])
def test_drag_matches_reference(bare, mode, dx, dy):
    """objdrag in each mode on one sphere, twice: every instance matrix of
    the scene within 1e-6 of the reference's; unknown objects and modes
    are refused in both."""
    for system in bare:
        for _ in range(2):
            assert system.display.drag_object("BallDielectric", dx, dy, mode)
        assert not system.display.drag_object("Nope", dx, dy, mode)
        assert not system.display.drag_object("BallDielectric", dx, dy, "shear")
    mats = [np.stack([np.asarray(ro.transform.matrix, np.float64)
                      for ro in s.world.render_objects]) for s in bare]
    assert mats[0].shape == mats[1].shape
    assert np.abs(mats[1] - mats[0]).max() <= 1e-6
    moved = bare[1].world.get_render_object("BallDielectric").transform.matrix
    fresh = _systems(with_pass=False)[1].world.get_render_object("BallDielectric")
    assert not np.allclose(moved, fresh.transform.matrix)


def test_console_state_matches_reference(pair):
    states = [s.display.console_state() for s in pair]
    for st in states:
        st.pop("fps"), st.pop("frame_time_ms")
        for p in st["passes"]:
            p.pop("time_ms")
    want, got = states
    assert got.keys() == want.keys()
    for key in want:
        if key == "objects":
            assert [o["name"] for o in got[key]] == [o["name"] for o in want[key]]
            for a, b in zip(got[key], want[key]):
                assert a["visible"] == b["visible"]
                np.testing.assert_allclose(a["matrix"], b["matrix"], rtol=0, atol=1e-6)
        elif key == "camera":
            np.testing.assert_allclose(got[key]["fov"], want[key]["fov"], rtol=1e-6)
            assert got[key]["sensitivity"] == want[key]["sensitivity"]
        else:
            assert got[key] == want[key], key


def _decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB PNG with filter 0 rows (what _encode_png writes) -> array."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack_from(">IIBB", chunks[b"IHDR"])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_encoder_round_trips():
    r = np.random.default_rng(5)
    img = r.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    png = _encode_png(img)
    np.testing.assert_array_equal(_decode_png(png), img)
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), img)
    grey = _encode_png(np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(grey))),
        (np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4) * 255 + 0.5).astype(np.uint8))


# -- the HTTP server ------------------------------------------------------------

def _film_copy(tmp: Path, size: int) -> Path:
    text = SCENE.read_text()
    text = re.sub(r'(<integer name="(?:width|height)" value=")\d+(")', rf"\g<1>{size}\g<2>", text)
    out = tmp / f"oracle_mat_{size}.xml"
    out.write_text(text)
    return out


@pytest.fixture(scope="module")
def web(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("web")
    system = System(display="web", web_port=0, device="cpu")
    system.add_pass(PTPass(max_depth=2))
    assert system.set_scene(_film_copy(tmp, 16))
    system.display.start()
    sensitivity = Camera.sensitivity
    yield system, tmp
    Camera.sensitivity = sensitivity  # a class attribute: leave it as found
    system.quit()
    system.display.shutdown()


def _url(system, path):
    return f"http://127.0.0.1:{system.display.port}{path}"


def _get(system, path):
    with urllib.request.urlopen(_url(system, path), timeout=30) as r:
        return r.read(), r.headers.get("Content-Type", "")


def _post(system, route, body):
    req = urllib.request.Request(_url(system, f"/api/{route}"), data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _state(system):
    return json.loads(_get(system, "/api/state")[0])


def test_http_page_state_and_frame(web):
    system, _ = web
    page, ctype = _get(system, "/")
    assert b"Console" in page and "text/html" in ctype
    assert b"<title>pupiloptixlab_tpu_torch</title>" in page
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(system, "/frame.png")  # no frame yet
    assert err.value.code == 503
    system.run(max_frames=2)
    state = _state(system)
    assert state["rendering"] is False  # the loop ended after its frames
    assert state["buffers"] == system.buffers.displayable_names()
    assert "pt frame" in state["buffers"] and state["selected"] == "pt frame"
    assert [p["name"] for p in state["passes"]] == ["Path Tracing"]
    assert state["passes"][0]["sample_cnt"] == 2 and state["passes"][0]["max_depth"] == 2
    assert {o["name"] for o in state["objects"]} >= {"Floor", "BallDielectric"}
    png, ctype = _get(system, "/frame.png")
    assert ctype == "image/png"
    np.testing.assert_array_equal(_decode_png(png), system.display.latest_image())
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(system, "/nothing")
    assert err.value.code == 404


def test_http_select_and_display_toggles(web):
    system, _ = web
    d = system.display
    assert _post(system, "select", {"name": "pt normal"})["ok"]
    assert _post(system, "display", {"tone_mapping": False, "gamma": False})["ok"]
    system.run(max_frames=1)
    state = _state(system)
    assert state["selected"] == "pt normal" and not state["tone_mapping"] and not state["gamma"]
    buf = system.buffers["pt normal"]
    want = (torch.clamp(expand_to_rgba(buf.array, 16, 16)[..., :3], 0, 1) * 255 + 0.5
            ).to(torch.uint8).flip(0).numpy()
    np.testing.assert_array_equal(d.latest_image(), want)
    assert _post(system, "select", {"name": "pt frame"})["ok"]
    assert _post(system, "display", {"tone_mapping": True, "gamma": True})["ok"]
    assert (d.selected, d.tone_mapping, d.gamma) == ("pt frame", True, True)


@pytest.mark.parametrize("body", [{"type": "drag", "dx": 30, "dy": -4},
                                  {"type": "wheel", "delta": 1},
                                  {"type": "key", "key": "W"}])
def test_http_canvas_input_restarts_accumulation(web, body):
    system, _ = web
    pt = system.passes[0]
    system.display.preview_hold_s = 3600.0  # the next frame is a preview however slow
    system.run(max_frames=2)
    assert pt.sample_cnt >= 2
    before = system.world.camera.to_world.copy(), system.world.camera.fov_y
    assert _post(system, "input", body)["ok"]
    assert pt._dirty and system.display.previewing
    system.run(max_frames=1)
    assert pt.sample_cnt == 1
    after = system.world.camera.to_world, system.world.camera.fov_y
    assert not np.array_equal(before[0], after[0]) or before[1] != after[1]
    # the preview's stride-2 image while the input is fresh
    assert system.display.latest_image().shape == (8, 8, 3)
    system.display.preview_hold_s, system.display._preview_until = 0.4, 0.0


def test_http_render_pass_and_camera(web):
    system, _ = web
    pt = system.passes[0]
    assert _post(system, "render", {"action": "stop"})["ok"]
    assert not system._render_flag.is_set()
    assert _post(system, "render", {"action": "start"})["ok"]
    assert system._render_flag.is_set()
    assert _post(system, "pass", {"name": "Path Tracing", "set": {"max_depth": 3}})["ok"]
    assert pt.max_depth_override == 3 and pt._dirty
    assert _post(system, "pass", {"name": "Path Tracing", "enabled": False})["ok"]
    cnt = pt.sample_cnt
    system.run(max_frames=1)
    assert pt.sample_cnt == cnt  # disabled: the frame skips it
    assert _post(system, "pass", {"name": "Path Tracing", "enabled": True,
                                  "set": {"max_depth": 2}})["ok"]
    system.run(max_frames=1)
    assert pt.sample_cnt == 1 and pt._config.max_depth == 2
    old = Camera.sensitivity
    assert _post(system, "camera", {"fov": 40.0, "sensitivity": old * 2})["ok"]
    assert abs(system.world.camera.fov_y - 40.0) < 1e-4 and Camera.sensitivity == old * 2
    assert pt._dirty
    assert _post(system, "camera", {"sensitivity": old})["ok"]
    state = _state(system)
    assert abs(state["camera"]["fov"] - 40.0) < 1e-4 and state["camera"]["sensitivity"] == old


def test_http_object_edits(web):
    system, _ = web
    pt = system.passes[0]
    ro = system.world.get_render_object("BallDiffuse")
    m0 = np.asarray(ro.transform.matrix).copy()
    system.run(max_frames=1)
    assert _post(system, "object", {"name": "BallDiffuse", "translate": [0.1, 0, 0]})["ok"]
    assert pt._dirty and system.world._instance_dirty
    np.testing.assert_allclose(ro.transform.matrix[:3, 3], m0[:3, 3] + [0.1, 0, 0], atol=1e-6)
    assert _post(system, "object", {"name": "BallDiffuse", "rotate": [0, 1, 0, 30]})["ok"]
    assert _post(system, "object", {"name": "BallDiffuse", "scale": [1.5, 1.5, 1.5]})["ok"]
    assert _post(system, "object", {"name": "BallDiffuse", "matrix": m0.reshape(-1).tolist()})["ok"]
    np.testing.assert_allclose(ro.transform.matrix, m0, rtol=0, atol=1e-6)
    assert _post(system, "object", {"name": "BallDiffuse", "visible": False})["ok"]
    state = _state(system)
    ball = next(o for o in state["objects"] if o["name"] == "BallDiffuse")
    assert ball["visible"] is False
    system.run(max_frames=1)  # the edits reach the frame through the device refit
    assert not system.world._instance_dirty and pt.sample_cnt == 1
    assert _post(system, "object", {"name": "BallDiffuse", "visible": True})["ok"]
    assert _post(system, "object", {"name": "NoSuchThing", "visible": True}) == {
        "ok": False, "error": "no such object"}


def test_http_pick_and_viewport_drag(web):
    system, _ = web
    pt = system.passes[0]
    # the camera moved in earlier tests: the first grid point that hits
    x, y = next((x, y) for y in np.linspace(0.05, 0.95, 10) for x in np.linspace(0.05, 0.95, 10)
                if system.display.pick_object(x, y)[0] is not None)
    r = _post(system, "pick", {"x": x, "y": y})
    name, t = system.display.pick_object(x, y)
    assert r == {"ok": True, "name": name, "t": round(float(t), 4)} and name is not None
    system.run(max_frames=2)
    ro = system.world.get_render_object(name)
    before = np.asarray(ro.transform.matrix).copy()
    assert _post(system, "objdrag", {"name": name, "dx": 0.05, "dy": 0.0,
                                     "mode": "translate"})["ok"]
    assert np.linalg.norm(ro.transform.matrix[:3, 3] - before[:3, 3]) > 1e-4
    system.run(max_frames=1)
    assert pt.sample_cnt == 1
    assert _post(system, "objdrag", {"name": name, "dx": 0.1, "dy": 0.05, "mode": "rotate"})["ok"]
    assert _post(system, "objdrag", {"name": name, "dx": 0.0, "dy": -0.1, "mode": "scale"})["ok"]
    assert _post(system, "objdrag", {"name": "Nope", "dx": 0.1, "dy": 0.0}) == {"ok": False}


def test_http_screenshot_and_stream(web):
    system, tmp = web
    system.run(max_frames=1)
    out = tmp / "shot.exr"
    r = _post(system, "screenshot", {"path": str(out)})
    assert r == {"ok": True, "path": str(out)}
    buf = system.buffers["pt frame"]
    np.testing.assert_array_equal(read_exr(out), expand_to_rgba(buf.array, 16, 16).flip(0).numpy())
    png = tmp / "shot.png"
    assert _post(system, "screenshot", {"path": str(png)})["ok"]
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(png)), system.display.latest_image())
    with urllib.request.urlopen(_url(system, "/stream"), timeout=30) as r:
        assert r.headers["Content-Type"].startswith("multipart/x-mixed-replace")
        data = r.read(2000)
    assert b"--frame" in data and b"image/jpeg" in data and b"\xff\xd8" in data


def test_http_scene_load_and_bad_requests(web):
    system, tmp = web
    assert _post(system, "nope", {}) == {"ok": False, "error": "unknown route nope"}
    req = urllib.request.Request(_url(system, "/api/select"), data=b"{not json")
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=30)
    assert err.value.code == 400
    old = system.world.scene
    assert _post(system, "scene", {"path": str(_film_copy(tmp, 8))})["ok"]
    t0 = time.monotonic()
    while (system.world.scene is old or not system._render_flag.is_set()) and \
            time.monotonic() - t0 < 60:
        time.sleep(0.02)
    assert system.world.scene is not old and system._render_flag.is_set()
    system.run(max_frames=1)
    assert system.display.latest_image().shape == (8, 8, 3)
    assert system.buffers["pt frame"].desc.width == 8


def test_http_edits_land_between_frames_of_the_render_thread(web):
    """System.run(threaded=True) serves the client (display.run blocks)
    while the render thread draws frames; 6 client threads post canvas
    drags, object drags, picks and state reads at once. Every object drag
    lands (the translation adds up, no update lost), frames keep coming,
    and quit ends both threads."""
    system, _ = web
    pt = system.passes[0]
    ro = system.world.get_render_object("BallPlastic")
    x0 = float(ro.transform.matrix[0, 3])
    frames = []
    from pupiloptixlab_tpu_torch.utils.event import FRAME_FINISHED

    system.events.bind(FRAME_FINISHED, frames.append)
    runner = threading.Thread(target=system.run, kwargs={"threaded": True})
    errors, drags = [], []
    switch = sys.getswitchinterval()

    def client(i):
        try:
            for _ in range(8):
                _post(system, "input", {"type": "drag", "dx": 1, "dy": 0})
                if _post(system, "object", {"name": "BallPlastic", "translate": [0.01, 0, 0]})["ok"]:
                    drags.append(1)
                _post(system, "pick", {"x": 0.3, "y": 0.6})
                _state(system)
        except Exception as exc:  # reported below: a failure must fail the test
            errors.append(exc)

    clients = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    sys.setswitchinterval(1e-5)  # interleave the threads finely
    try:
        runner.start()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        n_before = len(frames)
        t0 = time.monotonic()
        while len(frames) < n_before + 2 and time.monotonic() - t0 < 60:
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(switch)
        system.quit()
        runner.join(timeout=60)
    system._render_thread.join(timeout=60)
    assert not runner.is_alive() and not any(c.is_alive() for c in clients)
    assert not system._render_thread.is_alive()
    assert not errors, errors
    assert len(drags) == 48 and len(frames) >= n_before + 2
    np.testing.assert_allclose(ro.transform.matrix[0, 3], x0 + 48 * 0.01, atol=1e-4)
    assert pt.sample_cnt >= 1 and bool(torch.isfinite(system.buffers["pt frame"].array).all())
