"""Generate a scene of repeated shapes: the instanced path's test scene.

    python -m pupiloptixlab_tpu_torch.scene.instanced_grid OUT_DIR ENV_EXR \
        [N_INST] [GRID] [WIDTH] [HEIGHT]

``n_inst`` instances of one displaced-grid OBJ (``2 * grid**2`` triangles)
on a row-major 8-wide lattice, each turned by a seeded angle about y,
above a floor rectangle and lit by an HDR environment map only (the
reference's instanced test scene, tests/test_instanced.py, with the area
light swapped for the envmap so that the scene stays non-emissive and an
interactive world keeps its instanced tables; ``area_light=True`` puts
the reference's emissive rectangle back). At ``n_inst=64, grid=64`` the
instanced flatten holds 8,256 unique rows where the baked one holds
524,290 world triangles.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def write_instanced_scene(out_dir, env_exr, n_inst: int = 64, grid: int = 64,
                          width: int = 1920, height: int = 1080, max_depth: int = 4,
                          area_light: bool = False, seed: int = 3) -> Path:
    """Write ``bump.obj`` and ``instanced.xml`` into ``out_dir``; returns
    the XML's path."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    g = grid
    xs = np.linspace(-0.5, 0.5, g + 1)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    Y = 0.15 * np.sin(6.0 * X) * np.cos(5.0 * Z) + 0.15
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i = np.arange(g * (g + 1)).reshape(g, g + 1)[:, :g]
    v00 = i.ravel()
    v10 = v00 + (g + 1)
    v01 = v00 + 1
    v11 = v10 + 1
    faces = np.concatenate(
        [np.stack([v00, v11, v10], 1), np.stack([v00, v01, v11], 1)], 0
    )
    with open(out / "bump.obj", "w") as f:
        np.savetxt(f, verts, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, faces + 1, fmt="f %d %d %d")

    rng = np.random.RandomState(seed)
    shapes = []
    for k in range(n_inst):
        x = (k % 8 - 3.5) * 1.2
        z = (k // 8 - 3.5) * 1.2
        ang = float(rng.rand() * 360.0)
        shapes.append(f"""
  <shape type="obj">
    <string name="filename" value="bump.obj"/>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.6, 0.5, 0.4"/></bsdf>
    <transform name="to_world">
      <rotate y="1" angle="{ang:.2f}"/>
      <translate value="{x:.2f}, 0, {z:.2f}"/>
    </transform>
  </shape>""")
    light = """
  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="0, 0, 0"/></bsdf>
    <emitter type="area"><rgb name="radiance" value="10, 10, 10"/></emitter>
    <transform name="to_world">
      <scale value="2.5"/><rotate x="1" angle="90"/>
      <translate value="0, 8, 0"/>
    </transform>
  </shape>""" if area_light else ""
    xml = f"""<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="{max_depth}"/></integrator>
  <sensor type="perspective"><float name="fov" value="55"/>
    <transform name="to_world">
      <lookat origin="0, 7, 9" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm"><integer name="width" value="{width}"/>
      <integer name="height" value="{height}"/></film>
  </sensor>
  <emitter type="envmap">
    <string name="filename" value="{Path(env_exr).resolve()}"/>
  </emitter>
  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="0.5, 0.5, 0.5"/></bsdf>
    <transform name="to_world">
      <scale value="12"/><rotate x="1" angle="-90"/>
    </transform>
  </shape>{light}
  {''.join(shapes)}
</scene>"""
    path = out / "instanced.xml"
    path.write_text(xml)
    return path


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) < 2:
        sys.exit(__doc__)
    ints = [int(a) for a in args[2:]]
    print(write_instanced_scene(args[0], args[1], *ints))
