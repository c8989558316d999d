"""The plain reference against the port's own CPU path, at 32x32 on both
scenes, and the reference's independence of the port."""

import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import pixels as refpix
from conftest import REPO


def small_scene(tmp_path, name, film=(32, 32)):
    xml = (REPO / "benchmark" / "scenes" / f"{name}.xml").read_text()
    xml = re.sub(r'(name="width" value=")\d+', rf"\g<1>{film[0]}", xml)
    xml = re.sub(r'(name="height" value=")\d+', rf"\g<1>{film[1]}", xml)
    for d in ("meshes", "env"):
        (tmp_path / d).symlink_to(REPO / "benchmark" / "scenes" / d)
    path = tmp_path / f"{name}.xml"
    path.write_text(xml)
    return path


@pytest.mark.parametrize("name", ["mesh_env", "oracle_mat"])
def test_reference_equals_the_ports_cpu_render(tmp_path, name):
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.render.integrator import render
    from pupiloptixlab_tpu_torch.scene import load_scene

    path = small_scene(tmp_path, name)
    scene = load_scene(path)
    data, config = flatten_scene(scene, device="cpu")
    seed0, spp = 2**32 - 3, 3   # the seeds wrap past 2^32
    img = render(data, camera_block_from_scene(scene, device="cpu"), config, spp=spp,
                 seed0=seed0).reshape(-1, 3).numpy()
    ref = refpix.load(path, "cpu")
    pix = np.arange(32 * 32)
    got = refpix.accumulate(ref, pix, [seed0 + i for i in range(spp)])
    assert np.array_equal(got["accum"], img)


def test_camera_steps_move_as_the_viewer_moves():
    from pupiloptixlab_tpu_torch.system import System
    from pupiloptixlab_tpu_torch.utils.event import CAMERA_MOVE

    path = REPO / "benchmark" / "scenes" / "oracle_mat.xml"
    system = System(device="cpu")
    system.set_scene(path)
    keys = ["w", "s", "a", "a", "q", "e", "d"]
    for k in keys:
        system.events.dispatch(CAMERA_MOVE, refpix.KEY_DELTA[k])
    ref = refpix.load(path, "cpu")
    assert np.array_equal(ref.camera(keys).to_world, system.world.camera.to_world)


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.pixels as p\n"
            "r = p.load(%r, 'cpu')\n"
            "p.accumulate(r, [0, 5, 99], [1, 2])\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'pupiloptixlab_tpu', 'pupiloptixlab_tpu_torch'}))\n"
            % (str(REPO), str(REPO / "benchmark" / "scenes" / "oracle_mat.xml")))
    # a film of 1920x1080 is only flattened here, and 3 pixels traced
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    assert torch.__version__  # the reference needs torch alone
