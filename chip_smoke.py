#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
K3 and K4 alone:                  python3 chip_smoke.py --tables LABEL [--package DIR]
K7 and K8 alone:                  python3 chip_smoke.py --inst LABEL [--package DIR]
K1, K2 and K11 alone:             python3 chip_smoke.py --bvh LABEL [--package DIR]
K5 and K6 alone:                  python3 chip_smoke.py --sweep LABEL [--package DIR]
K10 alone:                        python3 chip_smoke.py --mt LABEL [--package DIR]
K9 alone:                         python3 chip_smoke.py --atrous LABEL [--package DIR]
Phase 22 alone:                   python3 chip_smoke.py --display LABEL [--package DIR]
Phase 23 alone:                   python3 chip_smoke.py --batch LABEL [--package DIR]
K12 and K13 alone:                python3 chip_smoke.py --bsdf LABEL
(--package DIR imports the package from another tree, for example a parent
commit unpacked with git archive, to time its kernels under this script's
timing in the same call; main_tables, main_inst, main_bvh, main_sweep,
main_mt, main_atrous, main_display and main_batch say what they run.)

Phases (each fails the run on its first fault; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    nvcc-build the CUDA kernels from csrc/ (pupiloptixlab_tpu_torch/_build/),
              one process per source; say whether the C++ or the numpy BVH
              build and OBJ parser ran
  3. kernels  K1-K4 against their plain PyTorch versions on data/mesh_env.xml
              at the main path's shapes (1920x1080 = 2,073,600 rays): the
              traversal kernels (K1 closest, K2 any hit) on primary, bounce
              and shadow rays, exact against the brute-force sweep on a
              65,536-ray subset and timed at full N; the gather (K3) on the
              texel pools and on each of the first bounce's own calls as its
              call site makes it (whole rows, column selections, a column of
              the strided material table, views), and the CDF count (K4) on
              the env row CDF and, in its row-indexed form, on the env
              column CDF at the first bounce's own rows and draws (equal on
              every lane to the former gather-compare-sum form), all
              bit-exact, each beside one PyTorch library call on the same
              inputs where there is one; each timed three ways: CUDA events
              around 10 calls (ms, what the kernels line sums), and device
              time apart from issue time (split_time_ms); one call of each
              wrapper form under torch.profiler, in a profiler window of its
              own, must issue exactly one kernel, its own (a window without
              the call's record, which CUPTI dropped, is repeated, up to 3
              windows); the launch path's pieces
              timed on the host; the sub-leaf gates of K1/K2
              (check_bvh_subleaf_gates): K1 and K2 with the sub-leaf table
              against the same kernels with an all-pass table (the full
              leaf scan) on all 2,073,600 lanes of the primary, bounce,
              shadow, unjittered and vertical rays (t bit-equal, rows and
              flags equal), a tie across two groups of one leaf that K1
              must give to the lower row, and the counting launcher
              bvh_closest_visits against tree_walk's pops, leaves, groups
              and rows on 1,024 seeded primary lanes
  4. frame    render_frame on the mesh_env BVH route at 1920x1080, depth 4:
              1 warm-up + 2 timed frames, launch counters reset just before
              and read just after; fails unless K1-K4 each launched
  5. sweep    K3 and K4 again, at the shapes the oracle_mat path gives them
              (its attribute, sphere, material, emitter and texture tables
              at the main path's own indices and column selections; its
              emitter-select CDF at its own draws), bit-exact and timed as in
              phase 3;
              K5 (closest) and K6 (any hit) against their plain versions,
              exact (row equal, t bit-equal, flag equal) on 65,536-lane
              subsets of the main path's primary, bounce and shadow rays and
              timed at full N, on (a) data/oracle_mat.xml's table (1 chunk),
              (b) mesh_env's table flattened under PUPIL_NO_BVH (321 chunks,
              11 super-boxes; here K5 at full N must also equal K1 bit for
              bit), (c) seeded triangle soups of 128, 512, 1,024 and 2,560
              rows: one case for each branch of the reference's
              sweep_triangles, and the largest table the default route
              makes (checked and timed, but outside the sums of the kernels
              line); every call passes the table's live rows (rows=);
              (d) K5 and K6 against themselves at rows = T with all-pass
              boxes (the full scan) on all 2,073,600 lanes of the primary,
              bounce, shadow, unjittered and vertical rays of oracle_mat,
              the four soups and mesh_env under PUPIL_NO_BVH (t bit-equal,
              rows and flags equal), and ties across two chunks (table
              order) and across two groups and their chunks (34 chunks,
              nearest first) that K5 must give to the lowest row
              (sweep_tie_case)
  6. system   System + PTPass through set_scene / run at 1920x1080, depth 4:
              oracle_mat (1 warm-up + 4 timed frames) and mesh_env under
              PUPIL_NO_BVH (1 warm-up + 2 timed), each with the counters
              reset before and read after; fails unless K5, K6, K3 and K4
              each launched. The film is set by a copy of the scene XML
              written to a temporary directory, with meshes/ and env/
              linked beside it
  7. parity   a 128x8 mesh_env film at seeds 0-3 on the card (kernels) and on
              the CPU (plain versions), and a 64x64 oracle_mat film through
              System at seeds 0-3, card against CPU: frame rel MSE <= 1e-5,
              >= 99% of pixels within rtol 1e-4, the RNG test AOV bit-equal;
              mesh_env 128x8 on the card with and without PUPIL_NO_BVH
              (rel MSE printed; the reference reports 0.0)
  8. oracle   render() at 64x64, 512 spp (through render_frame_batch: one
              captured sample replayed 512 times): mesh_env against
              tests/data/oracle_mesh_env_64.exr (mean ratio within 0.02, rel
              MSE < 1.5e-2) and oracle_mat against tests/data/oracle_mat_64.exr
              (mean ratio within 0.01, rel MSE < 4e-3, 4x4-box rel MSE < 1e-3)
 10. big_env  tools/make_big_scene.py (grid 450: 405,002 triangles, a 19.4 MB
              triangle table, 32-row leaves, the size the reference streams
              through its DMA ring) flattened at 1920x1080: K1 on primary and
              bounce rays and K2 on shadow rays exact against their plain
              versions on 65,536-lane subsets (the plain sweep over 405k rows
              at every lane would take minutes) and timed at full N; the
              sub-leaf gates of phase 3 on its five ray sets; K3 and K4
              at its shapes; render_frame 1 warm-up + 2 timed with the counts
              reset before and read after (K1-K4 must launch); the oracle gate
              of tests/test_oracle_parity.py at 48x48, 128 spp through render()
              and so render_frame_batch (tests/data/oracle_big_env_48.exr: mean
              ratio within 0.03, 4x4-box rel MSE < 2e-2); phase 23's
              batch-against-loop check at 1920x1080
 11. instanced pupiloptixlab_tpu_torch.scene.instanced_grid: 64 instances of an
              8,192-triangle shape, a floor and an envmap, through System +
              PTPass at 1920x1080, depth 4 (instanced tables: 8,256 unique
              rows, 8,193 world leaves of 64 rows, 65 instances): 1 warm-up +
              2 timed frames with the counts reset before and read after (K7,
              K8, K3, K4 must launch, K1, K2, K5, K6 must not); K7 on primary
              and bounce rays, K8 on shadow rays exact against their plain
              leaf scans on 65,536-lane subsets (t bit-equal, row and leaf
              equal, flags equal) and timed at full N (events around the
              wrapper, and a bare launch's device time apart from its issue
              time); the sub-leaf gates (check_subleaf_gates): K7 and K8 with
              the sub-leaf table against the same kernels with an all-pass
              table (the full leaf scan) on all 2,073,600 lanes of the
              primary, bounce, shadow, unjittered and vertical rays (t
              bit-equal, rows, leaves and flags equal), the last two also
              against the plain scans on 16,384 lanes, and a tie across two
              groups of one leaf that K7 must give to the lower row; K3 on
              the instance tables (I,12) and (I,16) and the rest of the
              path's tables, K4 on its env CDF; the instanced frame against
              the same scene's
              baked tables (524,290 rows on K1/K2) at equal seeds (99.5% of
              pixels within 2e-3, mean ratio within 2e-3); card against CPU
              frames at a 32x18 film (the phase 7 limits)
 12. refit    World.render_objects moves one instance and hides another, on
              the instanced scene and on mesh_env (baked): get_scene_data must
              refit without a flatten (counted), keep the instanced object
              tables (the sub-leaf boxes too) as they are, and give a fresh
              flatten's tables on live rows; refit and fresh flatten are
              timed; after the instanced edit K7 on 8,192 lanes of the
              primary rays against the plain leaf scan; after the mesh_env
              edit the baked sub-leaf table (row order kept, group boxes
              rebuilt from the moved rows, equal to a numpy build on live
              rows) and K1 against the brute sweep on 8,192 lanes
 13. denoise  K9 (atrous_iter) alone on bench.py's inputs (seed 3: random colour
              and albedo, unit normals) at 1920x1080, guided and unguided: each
              of the 5 launches of a denoise against its plain version on the
              same planes (atol 2e-6, rtol 1e-5) and the denoise against the
              plain filter, timed per launch and per denoise (outside the
              kernels line's sums); every other mode once at 256x144 on the
              card against the same call on the CPU (variance, AOV, temporal
              with motion, guided upscale, tiled; atol 1e-5, rtol 1e-5)
 14. mesh_env_denoise  System + PTPass + DenoisePass (USE_ALBEDO | USE_NORMAL,
              5 iterations) on mesh_env at 1920x1080, depth 4: 1 warm-up + 2
              frames without the denoiser, then 1 + 2 with it, the counts reset
              before and read after (K9 must launch 5 times a frame, K1-K4
              too); pt denoised against the plain filter on the same frame's
              buffers (atol 2e-6, rtol 1e-5), its std below the noisy frame's
              (tests/test_mesh_env.py:60-63); K9 on those buffers against its
              plain version (the kernels line's K9 numbers); a 32x18 film
              through System on the card against the CPU (phase 7's limits, on
              pt denoised too)
 15. mesh_env_mt32  mesh_env flattened under PUPIL_TCL=32 with PUPIL_MXU_MT (the
              port's intersect.MXU_MT) at 1920x1080: K10 (bvh_closest_mt) on
              primary and bounce rays, rows equal and t bit-equal against its
              plain version (the brute linear-form sweep) on 65,536-lane
              subsets, and against K1 on the same tables at full N (lanes on
              another row, or beyond rtol 3e-5 + atol 1e-5 on one row, the
              reference's limits, <= 1e-4 of the hits; on every lane of one row
              t within those limits plus the linear form's cancellation term,
              compare_mt_k1); render_frame 1 warm-up + 2 timed with the
              counts reset before and read after (K10 4 a frame, K1 none); the
              frame against K1's at equal seed (phase 7's limits); K10 with its
              tensor-core filter against the same kernel with every leaf on the
              CUDA cores (check_mt_tc_gate) on all 2,073,600 lanes of the primary,
              bounce, shadow, unjittered and vertical rays (t bit-equal, rows
              equal), with the share of its leaf tests on the tensor cores
              (non-zero on the primary rays)
 16. parallel (a) K1 and K2 on the seeded deep soup of scene/deep_soup.py (20,000
              triangles, a depth-11 tree whose walk may need 78 stack entries)
              at 65,536 rays, equal to their plain versions (rows equal, t
              bit-equal, flags equal), with the deepest stack the walk
              reached, and K1/K2 with its sub-leaf table equal to the
              all-pass table's run on all 65,536 rays; (b) K11
              (bvh_closest(count_iters=True)) on mesh_env's 1080p primary
              rays: t/idx bit-equal to K1 at full N, counts equal to
              plain_closest_counts on 64 whole tiles, timed in turns
              with K1, and the spread of the tiles' pops; (c) tile_costs and
              balanced_tile_perm for 1 and 3 ranks, render_frame with each
              permutation bit-equal to the frame without one (1080p, depth
              4), the counts set to 0 just before and read just after (K11
              and K1-K4 must launch); (d) render_frame_sharded,
              render_frame_balanced and render_samples_sharded over an NCCL
              group of world size 1, equal to the single-device calls, and
              ring_closest_bvh and ring_closest (K5 inner) equal to K1's t;
              (e) the ring's rounds at D = 4 in one process on big_env's
              table (phase 10) with 1080p primary rays, through K1 on each
              shard's own tree and through K5: t bit-equal to K1 over the
              whole table, rows off only on exact ties of t across shards
              (<= 1e-4 of the hits)
 17. spectral System + PTPass at 1920x1080: data/dispersion.xml (its own
              spectral integrator, depth 6, the chunk sweep: K5, K6, K3, K4
              must launch, K1 and K2 must not) and mesh_env under
              PTPass(spectral=True) (depth 4: K1-K4), 2 warm-up + 2 timed
              frames each, the counts set to 0 before and read after
 18. sanitizer  a mesh_env frame at 1920x1080 with debug_checks: the report
              all zeros; with NaN constant colours in a copy of the texture
              table assert_all_finite raises SanitizerError naming radiance
 19. restir   ReSTIRPass DI and GI at 1920x1080 through System on oracle_mat
              (the chunk sweep) and on mesh_env plus one area-lit rectangle
              built through the scene layer (K1/K2), 2 warm-up + 2 timed
              frames (GI's camera moves before its last frame)
 20. wavefront  render_wavefront at 1920x1080, spp 1, on mesh_env and
              oracle_mat: 1 warm-up + 2 timed, its iterations and host syncs
 21. parity   every path of 17-20 on the card against the CPU at equal seeds:
              spectral dispersion.xml 64x64 and mesh_env 128x8 (the sanitizer
              report equal too), ReSTIR DI and GI on oracle_mat 64x64 and the
              lit mesh_env 128x8 (2 frames; GI's second after a camera move),
              the wavefront frame on mesh_env 128x8 and oracle_mat 64x64
              (its film scatter adds in one order on both devices): rel MSE
              <= 1e-5, >= 99% of pixels within rtol 1e-4 (phase 7's limits)
 22. display  (a) System(display="web", web_port=0) + PTPass on mesh_env at
              1920x1080, depth 4, served by System.run(threaded=True) with its
              render thread running, driven over HTTP on 127.0.0.1: /api/state
              (the buffers, the pass, the objects), /frame.png (its IHDR
              1920x1080), /api/pick at the centre (the same object and t as
              pick_object on the host), /api/objdrag translate (the following
              frames run on refitted tables, no flatten, K1/K2 launched),
              /api/input drag (sample_cnt falls back), /api/screenshot to an
              EXR (equal to the selected buffer, flipped) and the first part
              of /stream where Pillow imports (whether Pillow and matplotlib
              import is printed); K1-K4 must launch in the phase, K5/K6 not;
              1080p frames timed with the client bound, at the preview's
              stride 2 and on a headless System, in turns, the pump alone
              (to_display_u8 + the uint8 fetch) and the PNG / JPEG encodes;
              (b) on the headless System: 3 frames, save_render_state, a
              fresh pass state, restore_render_state, 3 frames: the accum
              bit-equal to 6 uninterrupted frames; save and restore timed,
              the file's size; (c) FrameStats bound for 4 frames, then trace()
              around 2 frames with annotate("frame"): the written trace holds
              K1's kernel and both ranges; (d) ComputePass with
              examples/compute_test_torch.py's animate at 256x256 for 10
              frames: its buffers on the card within rtol 1e-6 / atol 1e-6 of
              the same pass on the CPU
 23. batch    render_frame_batch (on the card: one warm-up sample, then one
              sample captured into a CUDA graph and replayed spp times, the
              traversal fault flags read once after the replays) at 1920x1080,
              depth 4 (dispersion.xml its own 6), on the BVH route (mesh_env;
              big_env in phase 10), the chunk sweep (oracle_mat, mesh_env under
              PUPIL_NO_BVH), the instanced route, the matmul-form route
              (PUPIL_TCL=32 with intersect.MXU_MT) and spectral dispersion.xml:
              spp 8 from seed 0, count 0 and from seed 2^32 - 3, count 5,
              each against the eager loop of render_frame at the same seeds
              and counts (accum and the last sample's albedo, normal and test
              bit-equal); the counts set to 0 before each batch and read after:
              one replay launches the route's kernels and none of the other
              route's, and the batch nothing beyond its warm-up and replays;
              host ms a sample of the loop and the batch at spp 16 in turns
              (loop, batch, batch, loop) on mesh_env and oracle_mat, with the
              capture, instantiation and replay ms apart, the graph's nodes and
              each form's peak memory; mesh_env under PUPIL_TCL=32 with one leaf
              start moved 16 rows off its leaf grid: the batch raises after its
              replays naming bvh_closest (flag 4), render_frame raises too, the
              intact tables raise nothing
  9. no-jax   neither 'jax' nor any module of the JAX package is in sys.modules

Each kernel's bound_ms is the least time the card could take for the timed
calls: the larger of the bytes moved (each input read once, each output
written once) over 3.35 TB/s and the float operations this run's rays need
over 67 TFLOP/s (FP32 outside the tensor cores), both from the H100 SXM data
sheet. For the traversals and the culled sweep the operations are a floor
counted from this run's rays (the box tests every live ray must make and
the tests every hit ray must make: one row, K1, K11 and K7 18 +
MT_FLOPS_CLOSEST, K2 MT_FLOPS_ANY, K8 18 + MT_FLOPS_ANY; K10 its leaf's 32
linear-form rows; K5 18 + MT_FLOPS_CLOSEST, K6 MT_FLOPS_ANY; whatever the
kernel tests). The sweeps' bound counts the live rows alone (rows=: the
rows below it, their bytes and their boxes'), at every chunk count. K9's operations are counted
per tap (41 guided, 18 unguided) plus 10 per pixel, as csrc/atrous.cu says.

In the {"kernels": [...]} line each kernel's ms, plain_ms, library_ms and
bound_ms are sums over the timed calls at the shapes of the main paths it
runs on, and its launches the sum over the runs of those same paths
(launches_by_path has each run's own count): K1, K2 on the mesh_env BVH
frame and the big_env frame; K3, K4 on all five runs; K5, K6 on the two
chunk-sweep System runs; K7, K8 on the instanced System run; K9 on the
mesh_env_denoise run (its 5 launches on that frame's buffers); K10 on the
mesh_env_mt32 run (primary and bounce rays); K11 on the mesh_env_balanced
run (phase 16c: one launch per balance refresh, timed on the 1080p primary
rays, its plain version on the 64 tiles it is compared on). The launches of
phases 17-20, 22 and 23 are checked in those phases and are not in the line. On big_env and
the instanced scene the plain versions are timed on the 65,536-lane subset
they are compared on (``plain_n`` in chip_smoke.json), the kernels at full N.
K4's ms, plain_ms, bound_ms and library_ms cover its shared-form calls
alone, so that all four sum the same calls; its row-indexed calls, which
no one PyTorch call computes, have their own sums under "row_form"
(library_ms null, three_step_ms the former gather-compare-sum form on the
same inputs). Its launches count both forms.

Output: progress lines, then a {"kernels": [...]} JSON line, the
``nvidia-smi --query-gpu=name,power.limit`` line, and as the last line
{"ok": true, "device": {...}}. Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATA = REPO / "data"
MESH_ENV = DATA / "mesh_env.xml"
ORACLE_MAT = DATA / "oracle_mat.xml"
ORACLE_EXR = {
    "mesh_env": REPO / "tests" / "data" / "oracle_mesh_env_64.exr",
    "oracle_mat": REPO / "tests" / "data" / "oracle_mat_64.exr",
    "big_env": REPO / "tests" / "data" / "oracle_big_env_48.exr",
}
SUBSET = 65536
FILM = (1920, 1080)
BIG_GRID = 450              # tools/make_big_scene.py grid: 405,002 triangles
INST_N, INST_GRID = 64, 64  # instances, and grid of the repeated shape (8,192 tris)
SKY = DATA / "env" / "sky.exr"
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
MT_FLOPS_CLOSEST = 55       # per triangle test, the reference's cost estimates
MT_FLOPS_ANY = 50           # (pallas_intersect.py:183, :366)
SLAB_FLOPS = 22             # 6 sub/mul pairs + 10 min/max per box test
MT_FLOPS_LINEAR = 87        # K10 per row: 4 ten-term dots (76), det guard and
                            # division (3), the hit test's products and compares (8)
ATROUS_TAP_FLOPS = {True: 41, False: 18}  # K9 per tap, guided / unguided (csrc/atrous.cu)
ATROUS_PIXEL_FLOPS = 10     # centre luminance, the wsum guard, 1/wsum, 3 products
MT_CANCEL_K = 16            # K10 against K1 on one row: the cancellation term's
                            # count of float32 roundings (compare_mt_k1)
MT_DUMP_LANES = 256         # lanes beyond the reference's t limits kept in the json
DENOISE_ITERS = 5           # DenoisePass's default, as the reference's
MODES_FILM = (256, 144)     # the denoiser's other modes, card against CPU
MODES_TOL = dict(atol=1e-5, rtol=1e-5)  # cross-device: CPU and CUDA exp differ by
                                        # an ulp or so, through 5 chained iterations

_CSRC = "pupiloptixlab_tpu_torch/csrc/"
_PALLAS = "pupiloptixlab_tpu/accel/"
KERNEL_META = {
    "bvh_closest": (_CSRC + "bvh_traverse.cu", _PALLAS + "pallas_bvh.py:298, "
                    + _PALLAS + "pallas_bvh.py:447 (stream=True)"),
    "bvh_anyhit": (_CSRC + "bvh_traverse.cu", _PALLAS + "pallas_bvh.py:747, "
                   + _PALLAS + "pallas_bvh.py:855 (stream=True)"),
    "gather_planes": (_CSRC + "gather.cu",
                      _PALLAS + "gather.py:44, " + _PALLAS + "gather.py:152"),
    "count_less": (_CSRC + "gather.cu", _PALLAS + "gather.py:194"),
    "sweep_closest": (_CSRC + "sweep.cu", _PALLAS + "pallas_intersect.py:43, "
                      + _PALLAS + "pallas_intersect.py:198"),
    "sweep_anyhit": (_CSRC + "sweep.cu", _PALLAS + "pallas_intersect.py:97"),
    "bvh_closest_inst": (_CSRC + "bvh_traverse.cu",
                         _PALLAS + "pallas_bvh.py:298 (instanced=True, :304, :378)"),
    "bvh_anyhit_inst": (_CSRC + "bvh_traverse.cu",
                        _PALLAS + "pallas_bvh.py:747 (instanced=True, :753, :799)"),
    "atrous_iter": (_CSRC + "atrous.cu", "pupiloptixlab_tpu/denoise/pallas_atrous.py:54 "
                    "(_iter_kernel, via atrous_denoise_pallas :167)"),
    "bvh_closest_mt": (_CSRC + "bvh_traverse.cu", _PALLAS + "pallas_bvh.py:599 "
                       "(_make_closest_kernel_mxu, via bvh_closest(mxu=True) :1144)"),
    "bvh_closest_count": (_CSRC + "bvh_traverse.cu", _PALLAS + "pallas_bvh.py:298 "
                          "(_make_closest_kernel(count_iters=True), :514-590, via "
                          "bvh_closest(count_iters=True) :1126-1137)"),
}
# the main-path runs whose launches each kernel is counted on
ALL_PATHS = ("mesh_env_bvh", "oracle_mat", "mesh_env_nobvh", "big_env", "instanced")
PATHS_OF = {
    "bvh_closest": ("mesh_env_bvh", "big_env"),
    "bvh_anyhit": ("mesh_env_bvh", "big_env"),
    "gather_planes": ALL_PATHS,
    "count_less": ALL_PATHS,
    "sweep_closest": ("oracle_mat", "mesh_env_nobvh"),
    "sweep_anyhit": ("oracle_mat", "mesh_env_nobvh"),
    "bvh_closest_inst": ("instanced",),
    "bvh_anyhit_inst": ("instanced",),
    "atrous_iter": ("mesh_env_denoise",),
    "bvh_closest_mt": ("mesh_env_mt32",),
    "bvh_closest_count": ("mesh_env_balanced",),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SLEEP_CYCLES = 200_000_000  # ~0.1 s of torch.cuda._sleep at the H100's 1.98 GHz boost clock


def split_time_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(device ms, issue ms) per call, the two apart: ``reps`` calls are
    queued behind a ~0.1 s ``torch.cuda._sleep``, so the host issues them
    all while the card still sleeps. CUDA events recorded after the sleep
    and after the last call give the device's time for the calls alone
    (the kernels back to back, no wait for the host); the host clock
    around the calls gives the time to issue one. Fails if the host did
    not run ahead (the end event already complete when it was recorded)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    ahead = not end.query()
    torch.cuda.synchronize()
    require(ahead, "split_time_ms: the host did not run ahead of the card")
    return start.elapsed_time(end) / reps, issue_ms


def host_timed(fn):
    """(result, ms) of one call on the host clock, ended by a synchronise
    (the plain sweeps take up to seconds a call)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def host_time_ms(fn) -> float:
    return host_timed(fn)[1]


@contextlib.contextmanager
def pupil_env(name: str, value: str | None):
    """``name=value`` in the environment while a scene is flattened (nothing
    for None), read by flatten_scene as the reference's flatten reads it:
    PUPIL_NO_BVH=1 (the brute chunk sweep on a BVH-scale scene) or PUPIL_TCL
    (the least leaf size)."""
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)


def pupil_no_bvh(on: bool):
    return pupil_env("PUPIL_NO_BVH", "1" if on else None)


def load_tables(xml: Path, width: int, height: int, device, no_bvh: bool = False):
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.scene import load_scene

    scene = load_scene(xml)
    scene.sensor.film.w, scene.sensor.film.h = width, height
    with pupil_no_bvh(no_bvh):
        data, config = flatten_scene(scene, device=device)
    return data, config, camera_block_from_scene(scene, device=device)


def scene_copy(xml: Path, width: int, height: int, tmp: Path) -> Path:
    """A copy of the scene XML with the film set to width x height, in
    ``tmp`` with data/meshes and data/env linked beside it."""
    text = xml.read_text()
    for key, value in (("width", width), ("height", height)):
        text, count = re.subn(rf'(<integer name="{key}" value=")\d+(")',
                              rf"\g<1>{value}\g<2>", text)
        require(count == 1, f"{xml.name}: expected one film {key}, found {count}")
    for sub in ("meshes", "env"):
        if not (tmp / sub).exists():
            os.symlink(DATA / sub, tmp / sub)
    out = tmp / f"{xml.stem}_{width}x{height}.xml"
    out.write_text(text)
    return out


class Bound:
    """Sums, over the timed calls of one kernel, the least time the card
    could take for each: max(bytes / HBM rate, operations / FP32 rate)."""

    def __init__(self):
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, n_bytes: float, n_flops: float) -> tuple[float, str]:
        """This call's own bound and which of the two terms set it."""
        b = n_bytes / HBM_BYTES_PER_S * 1e3
        o = n_flops / FP32_FLOP_PER_S * 1e3
        self.bytes_ms += b
        self.ops_ms += o
        self.ms += max(b, o)
        return max(b, o), "bytes" if b >= o else "operations"

    def fields(self) -> dict:
        return {"bound_ms": self.ms,
                "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main_path_rays(data, config, cam, seed: int = 0):
    """Primary, first-bounce and first NEE shadow rays exactly as the
    frame builds them (render_sample + the first _bounce), and with them
    the (table, index) pairs of the first bounce's gathers ("gathers") and
    the (CDF, draws) of its emitter selection ("counts", empty for a scene
    without area emitters)."""
    import torch

    from pupiloptixlab_tpu_torch.accel.gather import count_less, gather_cols
    from pupiloptixlab_tpu_torch.accel.intersect import intersect_closest
    from pupiloptixlab_tpu_torch.flatten.types import (
        EM_AREA,
        EM_ETYPE,
        EM_RAD_TEX,
        EM_SELECT_PROB,
        INST_W2O0,
        MAT_DISPERSION,
        MAT_TEX0,
        MAT_TWOSIDED,
        SLOT_SPECULAR,
        SPH_FLIP,
    )
    from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
    from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
    from pupiloptixlab_tpu_torch.render import rng
    from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
    from pupiloptixlab_tpu_torch.render.integrator import lane_pixels, primary_rays
    from pupiloptixlab_tpu_torch.render import texture as texture_mod
    from pupiloptixlab_tpu_torch.render.sampling import RAY_OFFSET, is_zero, to_local, to_world

    pix = lane_pixels(config, device=data.tris.packed.device)
    state, primary = primary_rays(cam, config, seed, pix)
    ro, rd, tmin, tmax = primary

    hit = intersect_closest(ro, rd, tmin, tmax, data, config)
    geo = get_local_geometry(data, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        data.materials, data.textures, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    active = hit.hit_mask
    state, _ = rng.next_float(state)  # the test AOV draw
    state, us = rng.next_floats(state, 7)
    _, u_sel, u_l1, u_l2, u_b0, u_b1, u_b2 = us
    wo_local = to_local(-rd, geo.normal)

    idx, use_env = emitter_mod.select_emitter(data.emitters, config, u_sel)
    es = emitter_mod.sample_direct(data.emitters, data.textures, config, idx,
                                   use_env, geo.position, geo.normal, u_l1, u_l2)
    shadow_ok = active & (geo.normal.dot(es.wi) > 0.0)
    shadow = (geo.position, es.wi, tmin,
              torch.where(shadow_ok, es.distance - RAY_OFFSET, -1.0))

    wi_s, f_s, pdf_s, _ = bsdf_mod.sample(local, wo_local, u_b0, u_b1, u_b2,
                                          config.mat_types)
    bounce_ok = active & ~(is_zero(f_s * torch.abs(wi_s.z)) | is_zero(pdf_s))
    bounce = (geo.position, to_world(wi_s, geo.normal), tmin,
              torch.where(bounce_ok, tmax, -1.0))

    def i32(t):
        return t.to(torch.int32).contiguous()

    # the K3 calls of this bounce as the frame makes them: (table, indices,
    # the columns the call site selects, None for every column)
    mats, tex, em = data.materials.packed, data.textures, data.emitters
    texture_cols = texture_mod.texture_cols
    spec_tex = mats[geo.mat_id.long(), MAT_TEX0 + SLOT_SPECULAR]
    gathers = {"tris.attrs": (data.tris.attrs, i32(hit.prim), None),
               "materials.params": (mats, i32(geo.mat_id), tuple(range(MAT_DISPERSION + 1))),
               "materials.twosided": (mats, i32(geo.mat_id), (MAT_TWOSIDED,)),
               "textures.specular": (tex.packed, i32(spec_tex), texture_cols(
                   config.mat_tex_kinds, config.mat_tex_filters, tex.pool_bi.shape[0] > 1))}
    counts = {}
    if config.instanced:
        tr = data.tris
        gathers["tris.inst_w2o"] = (tr.inst_w2o, i32(hit.inst), None)
        gathers["tris.inst_packed"] = (tr.inst_packed, i32(hit.inst),
                                       tuple(range(INST_W2O0 + 1)))
    if config.sphere_count:
        sph = data.spheres.attrs
        gathers["spheres.attrs"] = (sph, i32(hit.prim.clamp(max=sph.shape[0] - 1)),
                                    tuple(range(SPH_FLIP + 1)))
    eid = i32(geo.emitter_id.clamp(min=0))
    gathers["emitters.rad_tex"] = (em.packed, eid, (EM_RAD_TEX,))
    gathers["emitters.eval"] = (em.packed, eid, (EM_AREA, EM_SELECT_PROB, EM_RAD_TEX))
    if config.emitter_count:
        erow = gather_cols(em.packed, idx)
        gathers["emitters.record"] = (em.packed, i32(idx), tuple(range(EM_ETYPE + 1)))
        gathers["textures.emission"] = (tex.packed, i32(erow[EM_RAD_TEX]), texture_cols(
            config.em_tex_kinds, config.em_tex_filters, tex.pool_bi.shape[0] > 1))
        counts["emitters.select_cdf"] = (
            em.select_cdf[:config.emitter_count].contiguous(), u_sel.contiguous())
    w, h = config.env_size
    if config.has_env and w > 0:
        # the envmap's two counts at this bounce's own draws (the row CDF
        # with u1, then that row of the column CDF with u2), and the row
        # weights at the sampled rows
        counts["env_row_cdf"] = (em.env_row_cdf, u_l1.contiguous())
        row = torch.clamp(count_less(em.env_row_cdf, u_l1) - 1, 0, h - 1)
        counts["env_col_cdf rows"] = (em.env_col_cdf, u_l2.contiguous(), row)
        gathers["env_row_weight"] = (em.env_row_weight[:, None], row, None)
        if h > 1:
            gathers["env_row_pairs"] = (em.env_row_weight.unfold(0, 2, 1),
                                        row.clamp(max=h - 2), None)
    return {"primary": primary, "bounce": bounce, "shadow": shadow,
            "gathers": gathers, "counts": counts}


def planes_of(rays, lanes=None):
    ro, rd, tmin, tmax = rays
    ps = [ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, tmin, tmax]
    ps = [p.expand(tmin.shape[0]) for p in ps]
    if lanes is not None:
        ps = [p[lanes] for p in ps]
    return [p.contiguous() for p in ps]


def pick_lanes(n: int, device):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randperm(n, generator=gen)[:SUBSET].to(device)


def check_gathers(scene, cases, k3, bound):
    """K3 on each (table, idx, cols) of ``cases`` as its call site makes it
    (``ga.gather_cols``; cols None = every column): bit-equal to its plain
    version and to one PyTorch call that computes the same planes
    (``index_select`` along the columns of the selected table's transpose),
    and timed beside both: CUDA events around 10 calls (ms), and device and
    issue time apart (split_time_ms). Times and the bound go to ``k3``'s
    sums."""
    import torch

    from pupiloptixlab_tpu_torch.accel import gather as ga

    for label, (table, idx, cols) in cases.items():
        def call():
            return ga.gather_cols(table, idx, cols)

        sel = table if cols is None else table[:, list(cols)]
        got = call()
        want = ga.gather_planes_plain(sel, idx)
        exact = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        safe = idx.clamp(0, table.shape[0] - 1)  # index_select takes no stray index
        planes_t = sel.t().contiguous()  # (K, T): the table in the planes' layout
        lib = planes_t.index_select(1, safe)
        require(bool(torch.equal(lib, want)), f"K3 {scene} {label}: index_select disagrees")
        ms = cuda_time_ms(call, reps=10)
        plain_ms = cuda_time_ms(lambda: ga.gather_planes_plain(sel, idx), reps=10)
        lib_ms = cuda_time_ms(lambda: planes_t.index_select(1, safe), reps=10)
        dev_ms, issue_ms = split_time_ms(call)
        lib_dev_ms, lib_issue_ms = split_time_ms(lambda: planes_t.index_select(1, safe))
        b_ms, by = bound.add(nbytes(sel, idx, got), 0.0)
        log(f"  K3 {scene} {label} {tuple(table.shape)} cols "
            f"{'all' if cols is None else len(cols)} N={idx.shape[0]}: bit-equal {exact}, "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f}, issue {issue_ms:.4f}), plain "
            f"{plain_ms:.3f} ms, index_select {lib_ms:.4f} ms (device {lib_dev_ms:.4f}, "
            f"issue {lib_issue_ms:.4f}), bound {b_ms:.4f} ms ({by})")
        require(exact, f"K3 {scene} {label}: kernel disagrees with table[idx].T")
        k3.setdefault("calls", {})[f"{scene} {label}"] = {
            "shape": list(table.shape), "strides": list(table.stride()),
            "cols": None if cols is None else list(cols), "n": idx.shape[0],
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": by, "device_ms": dev_ms, "issue_ms": issue_ms,
            "library_device_ms": lib_dev_ms, "library_issue_ms": lib_issue_ms}
        k3["ms"] += ms
        k3["plain_ms"] += plain_ms
        k3["library_ms"] += lib_ms
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
    k3.update(bound.fields())


def k4_record() -> dict:
    """K4's sums: the shared form's calls at the top level (ms, plain_ms,
    library_ms and bound_ms over the same calls), the row-indexed form's
    under ``row_form``, whose library_ms is None (no one PyTorch call
    computes it) and whose three_step_ms sums the former gather-compare-sum
    form on the same inputs."""
    sums = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    return {**sums, "library_ms": 0.0,
            "row_form": {**sums, "library_ms": None, "three_step_ms": 0.0}}


def k4_bounds() -> dict:
    return {"shared": Bound(), "rows": Bound()}


def check_counts(scene, cases, k4, bounds):
    """K4 on each case of ``cases``: (cdf, queries), the shared form, equal
    to the plain linear count and to torch.searchsorted (side='left' counts
    the entries strictly below); or (table, queries, rows), the row form,
    equal to its plain linear count and to the envmap's former three-step
    form (K3 gathers each query's whole row, compare, sum), with no single
    PyTorch call to set beside it. Each is timed as check_gathers times;
    the three-step form beside the row form. Sums go to ``k4``
    (k4_record), the bounds to ``bounds`` (k4_bounds), each form apart."""
    import torch

    from pupiloptixlab_tpu_torch.accel import gather as ga

    for label, case in cases.items():
        cdf, q = case[:2]
        rows = case[2] if len(case) == 3 else None
        if rows is None:
            require(bool((cdf[1:] >= cdf[:-1]).all()), f"{scene} {label} must be nondecreasing")
        else:
            require(bool((cdf[:, 1:] >= cdf[:, :-1]).all()),
                    f"{scene} {label}: every row must be nondecreasing")

            def three_step():
                return (ga.gather_cols(cdf, rows) < q[None, :]).sum(0, dtype=torch.int32)

            old = three_step()
            old_ms = cuda_time_ms(three_step, reps=10)
            old_dev_ms, old_issue_ms = split_time_ms(three_step)

        def call():
            return ga.count_less(cdf, q, rows=rows)

        def plain():
            return ga.count_less_plain(cdf, q, rows)

        got = call()
        want = plain()
        err = int((got - want).abs().max())
        ms = cuda_time_ms(call, reps=10)
        plain_ms = cuda_time_ms(plain, reps=3)
        dev_ms, issue_ms = split_time_ms(call)
        steps = max(int(cdf.shape[-1]).bit_length(), 1)  # compares of a binary search
        rec = {"shape": list(cdf.shape), "n": q.shape[0], "ms": ms, "plain_ms": plain_ms,
               "device_ms": dev_ms, "issue_ms": issue_ms}
        if rows is None:
            lib = torch.searchsorted(cdf, q).to(torch.int32)
            require(bool(torch.equal(lib, want)), f"K4 {scene} {label}: searchsorted disagrees")
            lib_ms = cuda_time_ms(lambda: torch.searchsorted(cdf, q), reps=10)
            lib_dev_ms, lib_issue_ms = split_time_ms(lambda: torch.searchsorted(cdf, q))
            rec.update(library_ms=lib_ms, library_device_ms=lib_dev_ms,
                       library_issue_ms=lib_issue_ms)
            b_ms, by = bounds["shared"].add(nbytes(cdf, q, got), q.shape[0] * steps)
            beside = (f"searchsorted {lib_ms:.4f} ms (device {lib_dev_ms:.4f}, issue "
                      f"{lib_issue_ms:.4f})")
            sums = k4
            sums["library_ms"] += lib_ms
        else:
            same_old = bool(torch.equal(got, old))
            rec.update(library_ms=None, three_step_ms=old_ms, three_step_device_ms=old_dev_ms,
                       three_step_issue_ms=old_issue_ms, equals_three_step=same_old)
            b_ms, by = bounds["rows"].add(nbytes(cdf, q, rows, got), q.shape[0] * steps)
            beside = (f"library call none; three-step form {old_ms:.4f} ms (device "
                      f"{old_dev_ms:.4f}, issue {old_issue_ms:.4f}), equal {same_old}")
            require(same_old, f"K4 {scene} {label}: the row form disagrees with the "
                    "gather-compare-sum form")
            sums = k4["row_form"]
            sums["three_step_ms"] += old_ms
        rec.update(bound_ms=b_ms, bound_by=by)
        log(f"  K4 {scene} {label} {tuple(cdf.shape)} N={q.shape[0]}: max |diff| {err}, "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f}, issue {issue_ms:.4f}), plain "
            f"{plain_ms:.3f} ms, {beside}, bound {b_ms:.4f} ms ({by})")
        require(err == 0, f"K4 {scene} {label}: kernel disagrees with the linear count")
        k4.setdefault("calls", {})[f"{scene} {label}"] = rec
        sums["ms"] += ms
        sums["plain_ms"] += plain_ms
        sums["max_abs_err"] = max(sums["max_abs_err"], float(err))
    k4.update(bounds["shared"].fields())
    k4["row_form"].update(bounds["rows"].fields())


def check_traversal(scene, data, config, rays, lanes, out, bounds, plain_subset):
    """K1 on primary and bounce rays, K2 on shadow (and, at full N, bounce)
    rays of one scene: exact against the brute sweep on ``lanes``, timed at
    full N. With ``plain_subset`` the plain versions are timed on the lane
    subset they are compared on (big_env: the brute sweep over 405k rows at
    every lane would take minutes), else at full N. Sums go to ``out``. The
    bound counts one row test a hit (18 + MT_FLOPS_CLOSEST), as K7's does,
    whatever the kernel tests."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tris = data.tris
    tabs = bvh_tables(tris)
    kw = dict(tcl=config.bvh_tcl, depth=tris.bvh_depth)
    n = config.width * config.height
    k1, k2 = out["bvh_closest"], out["bvh_anyhit"]

    def live_of(planes):
        return int((planes[7] > planes[6]).sum())

    for label in ("primary", "bounce"):
        full = planes_of(rays[label])
        t_k, i_k = bt.bvh_closest(*full, *tabs, **kw)
        sub = planes_of(rays[label], lanes)
        (t_p, i_p), sub_ms = host_timed(lambda: bt.plain_closest(*sub, tris.packed))
        t_ks, i_ks = t_k[lanes], i_k[lanes]
        mism = int((i_ks != i_p).sum())
        hit = i_p >= 0
        err = float((t_ks[hit] - t_p[hit]).abs().max()) if bool(hit.any()) else 0.0
        bit_t = bool(torch.equal(t_ks, t_p))
        log(f"  K1 {scene} {label}: {int(hit.sum())}/{lanes.numel()} hits, idx mismatches "
            f"{mism}, t bit-equal {bit_t}, max |dt| {err}")
        require(mism == 0 and bit_t, f"K1 {scene} {label}: kernel disagrees with the brute sweep")
        ms = cuda_time_ms(lambda: bt.bvh_closest(*full, *tabs, **kw), reps=5)
        plain_ms = sub_ms if plain_subset else host_time_ms(
            lambda: bt.plain_closest(*full, tris.packed))
        bound, by = bounds["bvh_closest"].add(
            nbytes(*full, *tabs, t_k, i_k),
            live_of(full) * 8 * SLAB_FLOPS + int((i_k >= 0).sum()) * (18 + MT_FLOPS_CLOSEST))
        plain_n = lanes.numel() if plain_subset else n
        log(f"  K1 {scene} {label}: kernel {ms:.3f} ms at N={n}, plain {plain_ms:.1f} ms at "
            f"N={plain_n}, bound {bound:.4f} ms ({by})")
        k1.setdefault("calls", {})[f"{scene} {label}"] = {
            "ms": ms, "plain_ms": plain_ms, "plain_n": plain_n, "bound_ms": bound,
            "bound_by": by, "hits": int(hit.sum()), "mismatches": mism}
        k1["ms"] += ms
        k1["plain_ms"] += plain_ms
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["mismatches"] += mism
        k1["hits"] += int(hit.sum())
    k1.update(bounds["bvh_closest"].fields())

    for label in (("shadow",) if plain_subset else ("shadow", "bounce")):
        full = planes_of(rays[label])
        occ_k = bt.bvh_anyhit(*full, *tabs, **kw)
        sub = planes_of(rays[label], lanes)
        occ_p, sub_ms = host_timed(lambda: bt.plain_anyhit(*sub, tris.packed))
        mism = int((occ_k[lanes] != occ_p).sum())
        log(f"  K2 {scene} {label}: {int(occ_p.sum())}/{lanes.numel()} occluded, "
            f"mismatches {mism}")
        require(mism == 0, f"K2 {scene} {label}: kernel disagrees with the brute sweep")
        if label == "shadow":
            ms = cuda_time_ms(lambda: bt.bvh_anyhit(*full, *tabs, **kw), reps=5)
            plain_ms = sub_ms if plain_subset else host_time_ms(
                lambda: bt.plain_anyhit(*full, tris.packed))
            bound, by = bounds["bvh_anyhit"].add(
                nbytes(*full, *tabs, occ_k),
                live_of(full) * 8 * SLAB_FLOPS + int(occ_k.sum()) * MT_FLOPS_ANY)
            plain_n = lanes.numel() if plain_subset else n
            log(f"  K2 {scene} shadow: kernel {ms:.3f} ms at N={n}, plain {plain_ms:.1f} ms "
                f"at N={plain_n}, bound {bound:.4f} ms ({by})")
            k2.setdefault("calls", {})[f"{scene} shadow"] = {
                "ms": ms, "plain_ms": plain_ms, "plain_n": plain_n, "bound_ms": bound,
                "bound_by": by, "occluded": int(occ_p.sum()), "mismatches": mism}
            k2["ms"] += ms
            k2["plain_ms"] += plain_ms
        k2["mismatches"] += mism
        k2["max_abs_err"] = max(k2["max_abs_err"], float(mism > 0))
    k2.update(bounds["bvh_anyhit"].fields())


def phase_kernels(data, config, cam, results):
    tris = data.tris
    rays = main_path_rays(data, config, cam)
    n = config.width * config.height
    lanes = pick_lanes(n, tris.packed.device)
    out = {name: {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0,
                  "library_ms": None} for name in ("bvh_closest", "bvh_anyhit")}
    out["bvh_closest"]["hits"] = 0
    bounds = {"bvh_closest": Bound(), "bvh_anyhit": Bound()}
    check_traversal("mesh_env", data, config, rays, lanes, out, bounds, plain_subset=False)
    results["subleaf_mesh_env"] = check_bvh_subleaf_gates(
        "mesh_env", data, config, bvh_ray_sets(data, config, cam))

    results["kernels"] = out
    bounds.update(check_mesh_env_tables(data, rays, results))
    check_one_launch(data, rays, results)
    launch_path_us(results)
    return bounds


def check_mesh_env_tables(data, rays, results):
    """K3 and K4 at mesh_env's shapes: K3 on the texel pool (the
    bilinear-quad pool too) at seeded texels and on the first bounce's own
    calls (the triangle attributes at the primary hit rows among them) (``rays``: main_path_rays), all bit-exact; K4
    on the env CDFs at seeded draws (env_cases) and at the first bounce's
    own draws and rows; beside each, the one PyTorch call that computes the
    same result where there is one. Returns K3's and K4's running bounds."""
    import torch

    tex = data.textures
    dev = tex.pool.device
    n = rays["primary"][2].shape[0]
    g = torch.Generator(device=dev).manual_seed(4)
    cases = {
        "pool": (tex.pool, torch.randint(0, tex.pool.shape[0], (n,), generator=g,
                                         device=dev, dtype=torch.int32), None),
        "pool_bi": (tex.pool_bi, torch.randint(0, tex.pool_bi.shape[0], (n,),
                                               generator=g, device=dev,
                                               dtype=torch.int32), None),
        **rays["gathers"],
    }
    counts = {**env_cases(data, n, seed=1), **rays["counts"]}
    k3 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    k3_bound = Bound()
    check_gathers("mesh_env", cases, k3, k3_bound)
    k4 = k4_record()
    k4_bound = k4_bounds()
    check_counts("mesh_env", counts, k4, k4_bound)
    results["kernels"]["gather_planes"] = k3
    results["kernels"]["count_less"] = k4
    return {"gather_planes": k3_bound, "count_less": k4_bound}


BVH_PATH = ("bvh_closest", "bvh_anyhit", "gather_planes", "count_less")


def phase_frame(data, config, cam, results, label="mesh_env", path=BVH_PATH, absent=()):
    """render_frame at the tables' film: 1 warm-up + 2 timed frames, the
    launch counts set to 0 just before and read just after; every kernel of
    ``path`` must launch, none of ``absent``."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    n = config.width * config.height
    accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
    iters = 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    render_frame(data, cam, 0, 0, accum, config)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(iters):
        _, bufs = render_frame(data, cam, i + 1, i + 1, accum, config)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    rays = n * (1 + 2 * (config.max_depth - 1))
    frame = bufs["frame"]
    finite = bool(torch.isfinite(frame).all())
    mean = float(frame.mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label} {config.width}x{config.height} depth {config.max_depth}: warm-up {warm_ms:.1f} ms, "
        f"{dt * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} Mray/s, mean {mean:.5f}, "
        f"peak {peak_gb:.2f} GB, launches over {1 + iters} frames {launches}")
    require(finite and mean > 0.0, f"{label}: frame is not finite and non-zero")
    require(all(launches[k] > 0 for k in path) and all(launches[k] == 0 for k in absent),
            f"{label}: the path must launch {path} and not {absent}: {launches}")
    results.setdefault("frames", {})[label] = {"ms_per_frame": dt * 1e3, "mrays_per_s": rays / dt / 1e6,
                        "warmup_ms": warm_ms, "mean": mean, "peak_gb": peak_gb,
                        "rays_per_frame": rays, "frames": 1 + iters,
                        "launches": launches}
    return launches


def make_soup(rows: int, device):
    """A seeded triangle soup inside oracle_mat's stage (so that the scene's
    rays cross it): ``rows`` table rows, the last 5 left as all-zero padding,
    sorted along x so that chunks are compact; returns (tri (rows, 12),
    chunk boxes (rows / 64, 8) built as the flatten builds them, the live
    row count rows - 5)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(rows)
    valid = rows - 5
    lo = torch.tensor([-4.0, 0.0, -2.5])
    hi = torch.tensor([4.0, 2.0, 3.0])
    p0 = lo + (hi - lo) * torch.rand((valid, 3), generator=g)
    p0 = p0[torch.argsort(p0[:, 0])]
    e1 = (torch.rand((valid, 3), generator=g) - 0.5) * 0.6
    e2 = (torch.rand((valid, 3), generator=g) - 0.5) * 0.6
    tri = torch.zeros((rows, 12))
    tri[:valid, 0:3], tri[:valid, 3:6], tri[:valid, 6:9] = p0, e1, e2
    verts = torch.stack([p0, p0 + e1, p0 + e2])  # (3, valid, 3)
    v_lo = torch.full((rows, 3), 1e30)
    v_hi = torch.full((rows, 3), -1e30)
    v_lo[:valid], v_hi[:valid] = verts.amin(0), verts.amax(0)
    boxes = torch.zeros((rows // 64, 8))
    boxes[:, 0:3] = v_lo.reshape(-1, 64, 3).amin(1)
    boxes[:, 3:6] = v_hi.reshape(-1, 64, 3).amax(1)
    return tri.to(device), boxes.to(device), valid


def check_sweeps(case, tri, boxes, rows, rays, lanes, plain_full, summed, k5, k6, bounds,
                 details):
    """K5 and K6 on one table (``rows`` its live rows, ``boxes`` its
    ``sweep_boxes``): exact against the plain versions on the lane subset,
    timed at full N; the plain versions are timed at full N for the ray
    sets named in ``plain_full``, and with ``summed`` (a main path's own
    table) those calls enter the sums of ``k5`` / ``k6`` (kernel, plain and
    bound over the same work). The bound counts the live rows alone: their
    bytes and their boxes', the box tests of every live ray (one a
    chunk-box group) and one row test for every ray that hits or is
    occluded."""
    import torch

    from pupiloptixlab_tpu_torch.accel import sweep as sw

    n = rays["primary"][2].shape[0]
    n_chunks = tri.shape[0] // sw.CHUNK
    n_groups = sw.group_count(n_chunks)
    live_chunks = -(-rows // sw.CHUNK)
    live_groups = sw.group_count(live_chunks) if live_chunks > sw.GROUP else 0
    tables = (tri[:rows], boxes[:live_chunks], boxes[n_chunks:n_chunks + live_groups])
    out = {"rows": tri.shape[0], "live_rows": rows, "chunks": n_chunks, "groups": n_groups}
    for label in ("primary", "bounce"):
        full = planes_of(rays[label])
        t_k, i_k = sw.sweep_closest(*full, tri, boxes, rows=rows)
        sub = planes_of(rays[label], lanes)
        t_p, i_p = sw.plain_sweep_closest(*sub, tri, boxes)
        t_ks, i_ks = t_k[lanes], i_k[lanes]
        mism = int((i_ks != i_p).sum())
        bit_t = bool(torch.equal(t_ks, t_p))
        hits = int((i_p >= 0).sum())
        err = float((t_ks - t_p).abs().max())
        ms = cuda_time_ms(lambda: sw.sweep_closest(*full, tri, boxes, rows=rows), reps=3)
        live = int((full[7] > full[6]).sum())
        flops = (live * n_groups * SLAB_FLOPS
                 + int((i_k >= 0).sum()) * (18 + MT_FLOPS_CLOSEST))
        n_bytes = nbytes(*full, *tables, t_k, i_k)
        rec = {"ms": ms, "hits": hits, "mismatches": mism, "t_bit_equal": bit_t}
        msg = (f"  K5 {case} {label}: {hits}/{lanes.numel()} hits, row mismatches {mism}, "
               f"t bit-equal {bit_t}; kernel {ms:.3f} ms")
        if label in plain_full:
            rec["plain_ms"] = host_time_ms(
                lambda: sw.plain_sweep_closest(*full, tri, boxes))
            rec["bound_ms"], rec["bound_by"] = (
                bounds["sweep_closest"] if summed else Bound()).add(n_bytes, flops)
            if summed:
                k5["ms"] += ms
                k5["plain_ms"] += rec["plain_ms"]
            msg += (f", plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
        log(msg + f" at N={n}")
        require(mism == 0 and bit_t, f"K5 {case} {label}: kernel disagrees with its plain version")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        k5["mismatches"] += mism
        out[f"closest_{label}"] = rec
    for label in ("shadow", "bounce"):
        full = planes_of(rays[label])
        occ_k = sw.sweep_anyhit(*full, tri, boxes, rows=rows)
        sub = planes_of(rays[label], lanes)
        occ_p = sw.plain_sweep_anyhit(*sub, tri, boxes)
        mism = int((occ_k[lanes] != occ_p).sum())
        ms = cuda_time_ms(lambda: sw.sweep_anyhit(*full, tri, boxes, rows=rows), reps=3)
        live = int((full[7] > full[6]).sum())
        occluded = int(occ_k.sum())
        flops = live * n_groups * SLAB_FLOPS + occluded * MT_FLOPS_ANY
        n_bytes = nbytes(*full, *tables, occ_k)
        rec = {"ms": ms, "occluded": int(occ_p.sum()), "mismatches": mism}
        msg = (f"  K6 {case} {label}: {int(occ_p.sum())}/{lanes.numel()} occluded, "
               f"mismatches {mism}; kernel {ms:.3f} ms")
        if label in plain_full:
            rec["plain_ms"] = host_time_ms(
                lambda: sw.plain_sweep_anyhit(*full, tri, boxes))
            rec["bound_ms"], rec["bound_by"] = (
                bounds["sweep_anyhit"] if summed else Bound()).add(n_bytes, flops)
            if summed:
                k6["ms"] += ms
                k6["plain_ms"] += rec["plain_ms"]
            msg += (f", plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
        log(msg + f" at N={n}")
        require(mism == 0, f"K6 {case} {label}: kernel disagrees with its plain version")
        k6["max_abs_err"] = max(k6["max_abs_err"], float(mism > 0))
        k6["mismatches"] += mism
        out[f"anyhit_{label}"] = rec
    details[case] = out


def phase_sweep(mesh_bvh, bounds, results):
    """Phase 5; ``mesh_bvh`` = mesh_env's BVH tables and config at 1080p,
    for K1 on the same rays; ``bounds`` = K3's and K4's running bounds from
    phase 3, which the oracle_mat calls add to."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.accel import sweep as sw
    from pupiloptixlab_tpu_torch.render.camera import generate_rays

    k5 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0,
          "library_ms": None}
    k6 = dict(k5)
    bounds = {**bounds, "sweep_closest": Bound(), "sweep_anyhit": Bound()}
    details: dict = {}

    # (a) oracle_mat's own table: one 64-row chunk, no box read
    data, config, cam = load_tables(ORACLE_MAT, *FILM, DEV)
    require(config.bvh_nodes == 0 and data.tris.packed.shape[0] == 64,
            "oracle_mat must flatten to one 64-row chunk without a BVH")
    n = config.width * config.height
    lanes = pick_lanes(n, data.tris.packed.device)
    rays_mat = main_path_rays(data, config, cam)
    # K3 and K4 at the shapes this path gives them: its own tables at the
    # first bounce's indices, its emitter-select CDF at the first draws
    require({"tris.attrs", "spheres.attrs", "materials.params", "emitters.record",
             "textures.emission"} <= set(rays_mat["gathers"])
            and list(rays_mat["counts"]) == ["emitters.select_cdf"],
            "oracle_mat must gather from triangles, spheres, materials, emitters and "
            "textures and select among area emitters")
    check_gathers("oracle_mat", rays_mat["gathers"], results["kernels"]["gather_planes"],
                  bounds["gather_planes"])
    check_counts("oracle_mat", rays_mat["counts"], results["kernels"]["count_less"],
                 bounds["count_less"])
    check_sweeps("oracle_mat", data.tris.packed, data.tris.sweep_boxes, config.tri_count,
                 rays_mat, lanes, ("primary", "bounce", "shadow"), True, k5, k6, bounds,
                 details)

    # (c) soups in oracle_mat's stage under oracle_mat's rays: 2 chunks (the
    # reference's _kernel_grid), 8 and 16 chunks (unrolled, no culling; 16
    # the largest table the default route makes), 40 chunks (2 super-boxes,
    # culled)
    for rows in SOUP_ROWS:
        tri, _, live = make_soup(rows, data.tris.packed.device)
        check_sweeps(f"soup_{rows}", tri, bt.sweep_boxes(tri), live, rays_mat, lanes,
                     ("primary",), False, k5, k6, bounds, details)
    del data, rays_mat

    # (b) mesh_env flattened under PUPIL_NO_BVH: 321 chunks, 11 super-boxes
    data, config, cam = load_tables(MESH_ENV, *FILM, DEV, no_bvh=True)
    tris = data.tris
    require(config.bvh_nodes == 0 and tris.chunk_boxes.shape[0] == 321,
            f"mesh_env under PUPIL_NO_BVH: {config.bvh_nodes} nodes, "
            f"{tris.chunk_boxes.shape[0]} chunks")
    rays = main_path_rays(data, config, cam)
    check_sweeps("mesh_env_nobvh", tris.packed, tris.sweep_boxes, config.tri_count, rays,
                 lanes, ("primary", "shadow"), True, k5, k6, bounds, details)
    # K5 against K1 at full N on the same rays. The two tables hold the same
    # triangles in another row order, so rows are compared by their content.
    bvh_data, bvh_config = mesh_bvh
    bt_tabs = bvh_tables(bvh_data.tris)
    # and on unjittered primary rays, 1,080 of which run along the plane
    # x = 0 with a zero x direction (box faces of both tables lie in it)
    zero = torch.zeros(n, device=DEV)
    rays["unjittered"] = (*generate_rays(cam, config.width, config.height, zero, zero),
                          *rays["primary"][2:])
    for label in ("primary", "bounce", "unjittered"):
        full = planes_of(rays[label])
        t5, i5 = sw.sweep_closest(*full, tris.packed, tris.sweep_boxes, rows=config.tri_count)
        t1, i1 = bt.bvh_closest(*full, *bt_tabs, tcl=bvh_config.bvh_tcl,
                                depth=bvh_data.tris.bvh_depth)
        bit_t = bool(torch.equal(t5, t1))
        hit = i5 >= 0
        same_hits = bool(torch.equal(hit, i1 >= 0))
        rows5 = tris.packed[i5[hit].long()]
        rows1 = bvh_data.tris.packed[i1[hit].long()]
        other_tri = int((rows5 != rows1).any(dim=1).sum())
        log(f"  K5 vs K1 mesh_env {label}: {int(hit.sum())}/{full[0].shape[0]} hits, "
            f"t bit-equal {bit_t}, hit lanes equal {same_hits}, lanes on another "
            f"triangle at the same t {other_tri}")
        require(bit_t and same_hits, f"K5 disagrees with K1 on mesh_env {label} rays")
        details["mesh_env_nobvh"][f"vs_k1_{label}"] = {
            "t_bit_equal": bit_t, "hits": int(hit.sum()), "tied_other_triangle": other_tri}
    del data, rays
    # (d) K5/K6 against their full scan (rows = T, all-pass boxes) on every
    # lane of five ray sets on each table, and the tie across chunks
    gates = {}
    for case, tri, _, rows, sets in sweep_scenes():
        boxes = bt.sweep_boxes(tri)
        gates[case] = {name: sweep_full_scan_gate(f"{case} {name}", full, tri, boxes, rows)
                       for name, full in sets.items()}
        log(f"  K5/K6 {case} against the full scan, every lane of five ray sets: "
            + ", ".join(f"{k} {v['hits']} hits / {v['occluded']} occluded, 0 off"
                        for k, v in gates[case].items()))
    details["full_scan"] = gates
    details["tie"] = check_sweep_tie()
    k5.update(bounds["sweep_closest"].fields())
    k6.update(bounds["sweep_anyhit"].fields())
    results["kernels"]["sweep_closest"] = k5
    results["kernels"]["sweep_anyhit"] = k6
    results["sweep"] = details
    return bounds


SYSTEM_PATH = ("sweep_closest", "sweep_anyhit", "gather_planes", "count_less")


def phase_system(label, xml, warm, iters, no_bvh, tmp, results):
    """System + PTPass as a user drives them, on the default device."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.passes import PTPass
    from pupiloptixlab_tpu_torch.system import System

    system = System()
    pt = PTPass()
    system.add_pass(pt)
    t0 = time.perf_counter()
    with pupil_no_bvh(no_bvh):
        require(system.set_scene(scene_copy(xml, *FILM, tmp)),
                f"{label}: set_scene failed")
    load_s = time.perf_counter() - t0
    config = pt._config
    require(str(system.device).startswith("cuda") and config.bvh_nodes == 0
            and (config.width, config.height, config.max_depth) == (*FILM, 4),
            f"{label}: expected the chunk-sweep route at 1920x1080 depth 4 on the card")
    n = config.width * config.height
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system.run(max_frames=warm)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    system.run(max_frames=iters)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    rays = n * (1 + 2 * (config.max_depth - 1))
    frame = system.buffers["pt frame"].array
    finite = bool(torch.isfinite(frame).all())
    mean = float(frame.mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = warm + iters
    table_rows = system.world.get_scene_data()[0].tris.packed.shape[0]
    log(f"  {label}: {config.tri_count} tris in {table_rows} "
        f"rows, {config.sphere_count} spheres, set_scene {load_s:.2f} s, warm-up "
        f"{warm_ms:.1f} ms, {dt * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} Mray/s, "
        f"mean {mean:.5f}, peak {peak_gb:.2f} GB, launches over {frames} frames {launches}")
    require(pt.sample_cnt == frames and pt.seed == frames,
            f"{label}: sample_cnt {pt.sample_cnt}, seed {pt.seed} after {frames} frames")
    require(tuple(frame.shape) == (n, 3) and finite and mean > 0.0,
            f"{label}: frame is not finite and non-zero")
    require(all(launches[k] > 0 for k in SYSTEM_PATH)
            and launches["bvh_closest"] == 0 and launches["bvh_anyhit"] == 0,
            f"{label}: the chunk-sweep path must launch K5, K6, K3, K4 and no "
            f"traversal kernel: {launches}")
    system.destroy()
    results.setdefault("system", {})[label] = {
        "ms_per_frame": dt * 1e3, "mrays_per_s": rays / dt / 1e6, "warmup_ms": warm_ms,
        "set_scene_s": load_s, "mean": mean, "peak_gb": peak_gb, "rays_per_frame": rays,
        "frames": frames, "launches": launches}
    return launches


def compare_frames(label, card, cpu, worst):
    """Phase 7's limits on one pair of buffer sets (card, CPU)."""
    import numpy as np

    a, b = card["frame"], cpu["frame"]
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    test_eq = bool(np.array_equal(card["test"], cpu["test"]))
    nmax = float(np.abs(card["normal"] - cpu["normal"]).max())
    amax = float(np.abs(card["albedo"] - cpu["albedo"]).max())
    log(f"  {label}: rel MSE {rel:.3e}, pixels within rtol 1e-4 {frac:.4f}, "
        f"test AOV equal {test_eq}, |d normal| {nmax:.2e}, |d albedo| {amax:.2e}")
    require(rel <= 1e-5 and frac >= 0.99 and test_eq,
            f"card and CPU frames disagree: {label}")
    worst["rel_mse"] = max(worst["rel_mse"], rel)
    worst["frac_within_1e-4"] = min(worst["frac_within_1e-4"], frac)
    worst["normal_max"] = max(worst["normal_max"], nmax)
    worst["albedo_max"] = max(worst["albedo_max"], amax)


def phase_parity(results):
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.passes import PTPass
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.system import System

    def frames_of(dev, no_bvh=False):
        data, config, cam = load_tables(MESH_ENV, 128, 8, dev, no_bvh=no_bvh)
        n = config.width * config.height
        accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        seq = []
        for i in range(4):
            _, bufs = render_frame(data, cam, i, i, accum, config)
            seq.append({k: v.cpu().numpy().copy() for k, v in bufs.items()})
        return seq

    def new_worst():
        return {"rel_mse": 0.0, "frac_within_1e-4": 1.0, "normal_max": 0.0,
                "albedo_max": 0.0}

    card, cpu = frames_of(DEV), frames_of("cpu")
    worst = new_worst()
    for i, (g, c) in enumerate(zip(card, cpu)):
        compare_frames(f"mesh_env 128x8 seed {i}", g, c, worst)
    results["parity"] = worst

    # the BVH route against the brute chunk sweep at equal seeds, both on the card
    sweep = frames_of(DEV, no_bvh=True)
    rels = []
    for i, (g, c) in enumerate(zip(card, sweep)):
        a, b = g["frame"], c["frame"]
        rels.append(float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))
        equal = all(np.array_equal(g[k], c[k]) for k in g)
        log(f"  mesh_env 128x8 seed {i}, BVH vs PUPIL_NO_BVH on the card: rel MSE "
            f"{rels[-1]:.3e}, all buffers bit-equal {equal}")
        require(rels[-1] <= 1e-5, f"BVH and chunk-sweep frames disagree at seed {i}")
    results["parity_bvh_vs_sweep_rel_mse"] = max(rels)

    # oracle_mat at its own 64x64 film through System, card against CPU
    names = ("pt frame", "pt albedo", "pt normal", "pt test")
    seqs = {}
    for dev in (DEV, "cpu"):
        system = System(device=dev)
        system.add_pass(PTPass())
        require(system.set_scene(ORACLE_MAT), "oracle_mat: set_scene failed")
        seq = []
        for _ in range(4):
            system.run(max_frames=1)
            seq.append({k.split()[1]: system.buffers[k].array.cpu().numpy().copy()
                        for k in names})
        system.destroy()
        seqs[dev] = seq
    worst = new_worst()
    for i, (g, c) in enumerate(zip(seqs[DEV], seqs["cpu"])):
        compare_frames(f"oracle_mat 64x64 through System, seed {i}", g, c, worst)
    results["parity_system_oracle_mat"] = worst


def phase_oracle(results):
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.render.integrator import render
    from pupiloptixlab_tpu_torch.utils.image import read_exr

    spp = 512
    limits = {"mesh_env": (MESH_ENV, 0.02, 1.5e-2, None),
              "oracle_mat": (ORACLE_MAT, 0.01, 4e-3, 1e-3)}
    out = {}
    for name, (xml, ratio_tol, mse_tol, box_tol) in limits.items():
        data, config, cam = load_tables(xml, 64, 64, DEV)
        t0 = time.perf_counter()
        img = render(data, cam, config, spp=spp).cpu().numpy()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        oracle = read_exr(ORACLE_EXR[name])[::-1][..., :3]
        mean_ratio = float(img.mean() / oracle.mean())
        rel_mse = float(np.mean((img - oracle) ** 2) / np.mean(oracle ** 2))

        def box(a):
            return a.reshape(16, 4, 16, 4, 3).mean((1, 3))

        box_rel = float(np.mean((box(img) - box(oracle)) ** 2) / np.mean(box(oracle) ** 2))
        log(f"  {name} 64x64 {spp} spp in {secs:.1f} s: mean ratio {mean_ratio:.5f}, "
            f"rel MSE {rel_mse:.5e}, 4x4-box rel MSE {box_rel:.5e}")
        require(np.isfinite(img).all(), f"{name}: oracle render is not finite")
        require(abs(mean_ratio - 1.0) < ratio_tol and rel_mse < mse_tol
                and (box_tol is None or box_rel < box_tol),
                f"{name} oracle gate failed (mean ratio within {ratio_tol}, rel MSE < "
                f"{mse_tol}, box rel MSE < {box_tol})")
        out[name] = {"mean_ratio": mean_ratio, "rel_mse": rel_mse, "box_rel_mse": box_rel,
                     "spp": spp, "seconds": secs}
    results["oracle"] = out


def env_cases(data, n, seed):
    """K4 on the env CDFs at seeded draws with the tables' own values among
    them (side='left' semantics): the row CDF, and the column CDF at seeded
    rows (some out of range) with draws equal to entries of their rows
    (flat runs where a row is black)."""
    import torch

    em = data.emitters
    dev = em.env_col_cdf.device
    g = torch.Generator(device=dev).manual_seed(seed)
    cdf = em.env_row_cdf
    q = torch.rand(n, generator=g, device=dev)
    q[:cdf.shape[0]] = cdf
    col = em.env_col_cdf
    h, w1 = col.shape
    rows = torch.randint(-3, h + 3, (n,), generator=g, device=dev, dtype=torch.int32)
    q2 = torch.rand(n, generator=g, device=dev)
    m = n // 4
    j = torch.randint(0, w1, (m,), generator=g, device=dev)
    q2[:m] = col[rows[:m].clamp(0, h - 1).long(), j]
    return {"env_row_cdf": (cdf, q), "env_col_cdf seeded rows": (col, q2, rows)}


def table_bytes(tris) -> dict:
    return {k: nbytes(getattr(tris, k)) for k in
            ("packed", "attrs", "bvh_boxes", "bvh_child", "leaf_start", "inst_w2o")}


def load_big_env(tmp):
    """big_env (``tools/make_big_scene.py`` into ``tmp``) flattened at
    1920x1080: (data, config, camera, generate s, flatten s, its directory,
    the scene)."""
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.scene import load_scene

    out_dir = tmp / "big_env"
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(REPO / "tools" / "make_big_scene.py"), str(out_dir),
                    str(BIG_GRID)], check=True, capture_output=True, timeout=600)
    gen_s = time.perf_counter() - t0
    scene = load_scene(scene_copy(out_dir / "big_env.xml", *FILM, out_dir))
    t0 = time.perf_counter()
    data, config = flatten_scene(scene, device=DEV)
    flatten_s = time.perf_counter() - t0
    cam = camera_block_from_scene(scene, device=DEV)
    return data, config, cam, gen_s, flatten_s, out_dir, scene


def phase_big_env(tmp, bounds, results):
    """Phase 10: big_env at 1920x1080 on K1/K2 at leaf size 32, and its
    48x48 oracle gate. Returns the run's launches and the 1080p tables
    (for phase 16's ring rounds, run right after this phase)."""
    import dataclasses

    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene
    from pupiloptixlab_tpu_torch.render.integrator import render
    from pupiloptixlab_tpu_torch.utils.image import read_exr

    data, config, cam, gen_s, flatten_s, out_dir, scene = load_big_env(tmp)
    tris = data.tris
    tb = table_bytes(tris)
    log(f"  big_env: generated in {gen_s:.1f} s, loaded and flattened in {flatten_s:.1f} s: "
        f"{config.tri_count} tris in {tris.packed.shape[0]} rows, tcl {config.bvh_tcl}, "
        f"{config.bvh_nodes} nodes, depth {tris.bvh_depth} (stack {7 * tris.bvh_depth + 1} "
        f"of {bt.STACK_SIZE}), table bytes {tb}")
    require(config.bvh_tcl == 32 and not config.instanced and config.bvh_nodes > 0
            and bt.stack_fits(tris.bvh_depth),
            "big_env must take the BVH route at leaf size 32 within the kernels' stack")
    rec = {"tri_count": config.tri_count, "rows": tris.packed.shape[0],
           "bvh_tcl": config.bvh_tcl, "bvh_nodes": config.bvh_nodes,
           "bvh_depth": tris.bvh_depth, "table_bytes": tb, "generate_s": gen_s,
           "flatten_s": flatten_s}
    n = config.width * config.height
    rays = main_path_rays(data, config, cam)
    lanes = pick_lanes(n, tris.packed.device)
    ks = results["kernels"]
    check_traversal("big_env", data, config, rays, lanes, ks, bounds, plain_subset=True)
    rec["subleaf"] = check_bvh_subleaf_gates("big_env", data, config,
                                             bvh_ray_sets(data, config, cam))
    check_gathers("big_env", rays["gathers"], ks["gather_planes"], bounds["gather_planes"])
    check_counts("big_env", {**rays["counts"], **env_cases(data, n, seed=2)},
                 ks["count_less"], bounds["count_less"])
    del rays
    launches = phase_frame(data, config, cam, results, label="big_env")

    # the reference's oracle gate at 48x48, 128 spp, on the same tables
    scene.sensor.film.w = scene.sensor.film.h = 48
    cam48 = camera_block_from_scene(scene, device=DEV)
    cfg48 = dataclasses.replace(config, width=48, height=48)
    t0 = time.perf_counter()
    img = render(data, cam48, cfg48, spp=128).cpu().numpy()
    secs = time.perf_counter() - t0
    oracle = read_exr(ORACLE_EXR["big_env"])[::-1][..., :3]
    mean_ratio = float(img.mean() / oracle.mean())

    def box(a):
        return a.reshape(12, 4, 12, 4, 3).mean((1, 3))

    box_rel = float(np.mean((box(img) - box(oracle)) ** 2) / np.mean(box(oracle) ** 2))
    rel_mse = float(np.mean((img - oracle) ** 2) / np.mean(oracle ** 2))
    log(f"  big_env 48x48 128 spp in {secs:.1f} s: mean ratio {mean_ratio:.5f}, rel MSE "
        f"{rel_mse:.5e}, 4x4-box rel MSE {box_rel:.5e}")
    require(np.isfinite(img).all() and abs(mean_ratio - 1.0) < 0.03 and box_rel < 2e-2,
            "big_env oracle gate failed (mean ratio within 0.03, box rel MSE < 2e-2)")
    rec["oracle"] = {"mean_ratio": mean_ratio, "rel_mse": rel_mse, "box_rel_mse": box_rel,
                     "spp": 128, "seconds": secs}
    results["big_env"] = rec
    # phase 23's batch-against-loop check on the large-scene route
    check_batch_route("big_env", data, config, cam, BVH_KERNELS, SWEEP_KERNELS[:2], results)
    return launches, (data, config, cam)


def inst_tables(tris) -> tuple:
    """K7/K8's table arguments after the rays, with the sub-leaf boxes
    where the package has them (a tree before the sub-leaf level, run with
    --inst --package, takes seven)."""
    tabs = (tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes, tris.leaf_start,
            tris.leaf_inst, tris.inst_w2o)
    sub = getattr(tris, "subleaf_boxes", None)
    return tabs if sub is None else (*tabs, sub)


def inst_device_ms(name, full, tabs, config, tris, want) -> tuple[float, float]:
    """(device ms, issue ms) of one K7 or K8 launch at full N through its
    ctypes launcher alone (split_time_ms): the wrappers read the fault flag
    after each launch, which waits for the card, so a wrapper call cannot
    run ahead of it. The launches' outputs must equal ``want`` (the
    wrapper's) and leave the flag clear."""
    import torch

    from pupiloptixlab_tpu_torch import kernels

    dev = full[0].device
    outs = [torch.empty_like(w) for w in want]
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (*(p.data_ptr() for p in full), *(t.data_ptr() for t in tabs), full[0].shape[0],
            tris.packed.shape[0], config.bvh_tcl, tris.bvh_axis.shape[0],
            tris.leaf_start.shape[0], *(o.data_ptr() for o in outs), err.data_ptr(),
            kernels.stream_ptr(dev))
    fn = kernels.launcher(name)
    dev_ms, issue_ms = split_time_ms(lambda: kernels.check(fn(*args), name), reps=5)
    require(int(err.item()) == 0 and all(torch.equal(o, w) for o, w in zip(outs, want)),
            f"{name}: the launcher's own calls disagree with the wrapper's")
    return dev_ms, issue_ms


def check_inst_traversal(data, config, rays, lanes, out, bounds):
    """K7 on primary and bounce rays, K8 on shadow rays: exact against the
    plain leaf scans on ``lanes`` (timed there), timed at full N: events
    around 5 wrapper calls (ms) and a launch's device time apart from its
    issue time (inst_device_ms). The bound counts the ray transform and one row test a
    hit as the unavoidable work, whatever the kernel tests."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    tabs = inst_tables(tr)
    plain_tabs = (tr.packed, tr.leaf_start, tr.leaf_inst, tr.inst_w2o)
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    n = config.width * config.height
    k7, k8 = out["bvh_closest_inst"], out["bvh_anyhit_inst"]
    for label in ("primary", "bounce"):
        full = planes_of(rays[label])
        t_k, i_k, l_k = bt.bvh_closest_inst(*full, *tabs, **kw)
        sub = planes_of(rays[label], lanes)
        (t_p, i_p, l_p), plain_ms = host_timed(
            lambda: bt.plain_closest_inst(*sub, *plain_tabs, tcl=config.bvh_tcl))
        t_ks, i_ks, l_ks = t_k[lanes], i_k[lanes], l_k[lanes]
        mism = int(((i_ks != i_p) | (l_ks != l_p)).sum())
        hit = i_p >= 0
        err = float((t_ks[hit] - t_p[hit]).abs().max()) if bool(hit.any()) else 0.0
        bit_t = bool(torch.equal(t_ks, t_p))
        ms = cuda_time_ms(lambda: bt.bvh_closest_inst(*full, *tabs, **kw), reps=5)
        dev_ms, issue_ms = inst_device_ms("bvh_closest_inst", full, tabs, config, tr,
                                          (t_k, i_k, l_k))
        live = int((full[7] > full[6]).sum())
        bound, by = bounds["bvh_closest_inst"].add(
            nbytes(*full, *tabs, t_k, i_k, l_k),
            live * 8 * SLAB_FLOPS + int((i_k >= 0).sum()) * (18 + MT_FLOPS_CLOSEST))
        log(f"  K7 {label}: {int(hit.sum())}/{lanes.numel()} hits, (row, leaf) mismatches "
            f"{mism}, t bit-equal {bit_t}; kernel {ms:.3f} ms at N={n} (device "
            f"{dev_ms:.3f}, issue {issue_ms:.4f}), plain {plain_ms:.1f} ms at "
            f"N={lanes.numel()}, bound {bound:.4f} ms ({by})")
        require(mism == 0 and bit_t, f"K7 {label}: kernel disagrees with the plain leaf scan")
        k7.setdefault("calls", {})[f"instanced {label}"] = {
            "ms": ms, "device_ms": dev_ms, "issue_ms": issue_ms, "plain_ms": plain_ms,
            "plain_n": lanes.numel(), "bound_ms": bound, "bound_by": by,
            "hits": int(hit.sum()), "mismatches": mism}
        k7["ms"] += ms
        k7["plain_ms"] += plain_ms
        k7["max_abs_err"] = max(k7["max_abs_err"], err)
        k7["mismatches"] += mism
    k7.update(bounds["bvh_closest_inst"].fields())
    full = planes_of(rays["shadow"])
    occ_k = bt.bvh_anyhit_inst(*full, *tabs, **kw)
    occ_p, plain_ms = host_timed(lambda: bt.plain_anyhit_inst(
        *planes_of(rays["shadow"], lanes), *plain_tabs, tcl=config.bvh_tcl))
    mism = int((occ_k[lanes] != occ_p).sum())
    ms = cuda_time_ms(lambda: bt.bvh_anyhit_inst(*full, *tabs, **kw), reps=5)
    dev_ms, issue_ms = inst_device_ms("bvh_anyhit_inst", full, tabs, config, tr, (occ_k,))
    live = int((full[7] > full[6]).sum())
    bound, by = bounds["bvh_anyhit_inst"].add(
        nbytes(*full, *tabs, occ_k),
        live * 8 * SLAB_FLOPS + int(occ_k.sum()) * (18 + MT_FLOPS_ANY))
    log(f"  K8 shadow: {int(occ_p.sum())}/{lanes.numel()} occluded, mismatches {mism}; "
        f"kernel {ms:.3f} ms at N={n} (device {dev_ms:.3f}, issue {issue_ms:.4f}), plain "
        f"{plain_ms:.1f} ms at N={lanes.numel()}, bound {bound:.4f} ms ({by})")
    require(mism == 0, "K8 shadow: kernel disagrees with the plain leaf scan")
    k8.setdefault("calls", {})["instanced shadow"] = {
        "ms": ms, "device_ms": dev_ms, "issue_ms": issue_ms, "plain_ms": plain_ms,
        "plain_n": lanes.numel(), "bound_ms": bound, "bound_by": by,
        "occluded": int(occ_p.sum()), "mismatches": mism}
    k8["ms"] += ms
    k8["plain_ms"] += plain_ms
    k8["mismatches"] += mism
    k8["max_abs_err"] = max(k8["max_abs_err"], float(mism > 0))
    k8.update(bounds["bvh_anyhit_inst"].fields())


def inst_visit_counts(data, config, rays) -> dict:
    """World leaves, sub-leaf groups and rows that K7's walk tests per live
    ray on each ray set at full N (shadow rays through K7 too: an upper
    bound on K8's walk, which stops at its first hit), from the counting
    instantiation of K7 (launch_bvh_closest_inst_count, for measurement
    only), whose (t, row, leaf) must equal K7's."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    tabs = inst_tables(tr)
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    fn = kernels.launcher("bvh_closest_inst_count")
    out = {}
    for label in ("primary", "bounce", "shadow"):
        full = planes_of(rays[label])
        n = full[0].shape[0] // bt.COUNT_TILE * bt.COUNT_TILE
        full = [p[:n].contiguous() for p in full]
        dev = full[0].device
        t = torch.empty(n, device=dev)
        i = torch.empty(n, dtype=torch.int32, device=dev)
        leaf = torch.empty(n, dtype=torch.int32, device=dev)
        counts = torch.zeros((n // bt.COUNT_TILE, 4), dtype=torch.int32, device=dev)
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        rc = fn(*(p.data_ptr() for p in full), *(x.data_ptr() for x in tabs),
                n, tr.packed.shape[0], config.bvh_tcl, tr.bvh_axis.shape[0],
                tr.leaf_start.shape[0], t.data_ptr(), i.data_ptr(), leaf.data_ptr(),
                counts.data_ptr(), err.data_ptr(), kernels.stream_ptr(dev))
        kernels.check(rc, "bvh_closest_inst_count")
        require(int(err.item()) == 0, "bvh_closest_inst_count: traversal fault flag")
        t7, i7, l7 = bt.bvh_closest_inst(*full, *tabs, **kw)
        require(bool(torch.equal(t, t7) and torch.equal(i, i7) and torch.equal(leaf, l7)),
                f"the counting K7 disagrees with K7 on {label} rays")
        live = max(int((full[7] > full[6]).sum()), 1)
        tot = counts.to(torch.int64).sum(dim=0).tolist()
        per_tile = counts[:, 1].to(torch.float64)
        rec = {"live": live, "hits": int((i >= 0).sum()),
               "pops_per_ray": tot[0] / live, "leaves_per_ray": tot[1] / live,
               "groups_per_ray": tot[2] / live, "rows_per_ray": tot[3] / live,
               "leaves_per_tile_max_over_mean": float(per_tile.max() / per_tile.mean())}
        log(f"  visits {label}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}" for k, v in rec.items()))
        out[label] = rec
    return out


def vertical_rays(lo, hi, width: int, height: int) -> list:
    """Rays of direction exactly (0, -1, 0) from a width x height grid of
    origins over the box (lo, hi), above it, as planes."""
    import torch

    from pupiloptixlab_tpu_torch.render.sampling import MAX_DISTANCE, RAY_OFFSET

    n = width * height
    xs = torch.linspace(float(lo[0]), float(hi[0]), width, device=DEV)
    zs = torch.linspace(float(lo[2]), float(hi[2]), height, device=DEV)
    gz, gx = torch.meshgrid(zs, xs, indexing="ij")
    ox, oz = gx.reshape(-1).contiguous(), gz.reshape(-1).contiguous()
    oy = torch.full((n,), float(hi[1]) + 1.0, device=DEV)
    return [ox, oy, oz, torch.zeros(n, device=DEV), torch.full((n,), -1.0, device=DEV),
            torch.zeros(n, device=DEV), torch.full((n,), RAY_OFFSET, device=DEV),
            torch.full((n,), MAX_DISTANCE, device=DEV)]


def extra_rays(data, config, cam, box=None) -> dict:
    """Two more 1080p ray sets as planes: the frame's unjittered primary
    rays (generate_rays with zero jitter, as phase 16 (b2) makes them on
    mesh_env), and vertical rays (direction exactly (0, -1, 0)) from a
    1920 x 1080 grid of origins over ``box`` (lo, hi), by default the
    tree's root box, above it: their x and z directions are 0 (on an
    instanced scene, under an instance's rotation about y, 0 or nearly 0 in
    object space)."""
    import torch

    from pupiloptixlab_tpu_torch.render.camera import generate_rays
    from pupiloptixlab_tpu_torch.render.sampling import MAX_DISTANCE, RAY_OFFSET

    n = config.width * config.height
    zero = torch.zeros(n, device=DEV)
    tmin = torch.full((n,), RAY_OFFSET, device=DEV)
    tmax = torch.full((n,), MAX_DISTANCE, device=DEV)
    ro, rd = generate_rays(cam, config.width, config.height, zero, zero)
    out = {"unjittered": planes_of((ro, rd, tmin, tmax))}
    if box is None:
        root = data.tris.bvh_boxes[0:8]
        root = root[root[:, 0] < 1e30]
        box = root[:, 0:3].amin(0), root[:, 3:6].amax(0)
    out["vertical"] = vertical_rays(*box, config.width, config.height)
    return out


def subleaf_tie_case():
    """A one-leaf instanced table (64 rows, an identity instance) in which
    row 0 and row 56 hold the same triangle T = (0,0,0), (1,0,0), (0,1,0);
    group 7 (rows 56-63) also holds a triangle at z = -1 off the rays'
    path, so its box starts nearer than group 0's and near-first order
    tests row 56 before row 0. Rays from z = -5 along +z through T hit
    both rows at one t: K7 must return row 0, as the plain scan does.
    Returns (planes, table arguments, tcl)."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tcl = 64
    packed = torch.zeros((tcl, 12))
    tri = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    packed[0, 0:9] = tri
    packed[56, 0:9] = tri
    packed[57, 0:9] = torch.tensor([5.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    for g in range(1, 7):  # one far triangle in each middle group
        packed[8 * g, 0:9] = torch.tensor([10.0, 0.0, 3.0 + g, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    boxes = torch.zeros((8, 8))
    boxes[:, 0:6] = 1e30  # empty slots: the never-box
    boxes[0, 0:6] = torch.tensor([-1.0, -1.0, -2.0, 12.0, 2.0, 10.0])
    child = torch.tensor([-1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    w2o = torch.tensor([[1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0]])
    packed, boxes, child, w2o = (x.to(DEV) for x in (packed, boxes, child, w2o))
    tabs = (packed, child, torch.zeros(1, dtype=torch.int32, device=DEV), boxes,
            torch.zeros(1, dtype=torch.int32, device=DEV),
            torch.zeros(1, dtype=torch.int32, device=DEV), w2o,
            bt.make_subleaf_boxes(packed, tcl))
    g = torch.linspace(0.05, 0.45, 32, device=DEV)
    gx, gy = [a.reshape(-1).contiguous() for a in torch.meshgrid(g, g, indexing="ij")]
    n = gx.shape[0]
    planes = [gx, gy, torch.full((n,), -5.0, device=DEV), torch.zeros(n, device=DEV),
              torch.zeros(n, device=DEV), torch.ones(n, device=DEV),
              torch.full((n,), 1e-3, device=DEV), torch.full((n,), 1e16, device=DEV)]
    return planes, tabs, tcl


def check_subleaf_gates(data, config, cam, rays, lanes) -> dict:
    """K7/K8 with the sub-leaf table against the same kernels with an
    all-pass table, whose every group box holds its whole leaf (+-1e30):
    that run tests every row of every leaf it reaches, the full leaf scan,
    by data and not by a flag. On all 2,073,600 lanes of the primary,
    bounce, shadow, unjittered and vertical rays: K7's t bit-equal, rows
    and leaves equal; K8's flags equal. The unjittered and vertical rays
    are also held against the plain leaf scans on ``lanes``. Then the
    cross-group tie (subleaf_tie_case): K7 must return the lower row."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    tabs = inst_tables(tr)
    sub = tabs[-1]
    allpass = torch.tensor([-1e30, -1e30, -1e30, 1e30, 1e30, 1e30, 0.0, 0.0],
                           device=DEV).expand_as(sub).contiguous()
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    plain_tabs = (tr.packed, tr.leaf_start, tr.leaf_inst, tr.inst_w2o)
    sets = {k: planes_of(rays[k]) for k in ("primary", "bounce", "shadow")}
    sets.update(extra_rays(data, config, cam))
    out = {}
    for label, full in sets.items():
        t7, i7, l7 = bt.bvh_closest_inst(*full, *tabs, **kw)
        ta, ia, la = bt.bvh_closest_inst(*full, *tabs[:-1], allpass, **kw)
        o8 = bt.bvh_anyhit_inst(*full, *tabs, **kw)
        oa = bt.bvh_anyhit_inst(*full, *tabs[:-1], allpass, **kw)
        rec = {"lanes": full[0].shape[0], "hits": int((i7 >= 0).sum()),
               "occluded": int(o8.sum()), "k7_t_off": int((t7 != ta).sum()),
               "k7_rows_off": int(((i7 != ia) | (l7 != la)).sum()),
               "k8_flags_off": int((o8 != oa).sum())}
        if label in ("unjittered", "vertical"):
            ps = [p[lanes] for p in full]
            tp, ip, lp = bt.plain_closest_inst(*ps, *plain_tabs, tcl=config.bvh_tcl)
            op = bt.plain_anyhit_inst(*ps, *plain_tabs, tcl=config.bvh_tcl)
            rec.update(plain_lanes=lanes.numel(), plain_hits=int((ip >= 0).sum()),
                       plain_t_off=int((t7[lanes] != tp).sum()),
                       plain_rows_off=int(((i7[lanes] != ip) | (l7[lanes] != lp)).sum()),
                       plain_flags_off=int((o8[lanes] != op).sum()))
        log(f"  sub-leaf {label}: {rec}")
        require(rec["hits"] > 0 and all(v == 0 for k, v in rec.items() if k.endswith("_off")),
                f"K7/K8 with the sub-leaf table disagree on {label} rays")
        out[label] = rec
    planes, ttabs, tcl = subleaf_tie_case()
    t7, i7, l7 = bt.bvh_closest_inst(*planes, *ttabs, tcl=tcl, depth=1)
    tp, ip, lp = bt.plain_closest_inst(*planes, *ttabs[0:1], *ttabs[4:7], tcl=tcl)
    o8 = bt.bvh_anyhit_inst(*planes, *ttabs, tcl=tcl, depth=1)
    rec = {"lanes": planes[0].shape[0], "rows": sorted(set(i7.tolist())),
           "plain_rows": sorted(set(ip.tolist())), "t_equal_plain": bool(torch.equal(t7, tp)),
           "occluded": int(o8.sum())}
    log(f"  sub-leaf tie across groups 0 and 7: {rec}")
    require(rec["rows"] == [0] and rec["plain_rows"] == [0] and rec["t_equal_plain"]
            and bool((l7 == 0).all()) and rec["occluded"] == rec["lanes"],
            "K7 must keep the lower row of a tie across sub-leaf groups")
    out["tie"] = rec
    return out


INST_PATH = ("bvh_closest_inst", "bvh_anyhit_inst", "gather_planes", "count_less")


def phase_instanced(tmp, bounds, results):
    """Phase 11: the instanced scene through System + PTPass at 1920x1080,
    K7/K8 and K3/K4 at its shapes, against its baked tables and the CPU."""
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.flatten import flatten_scene
    from pupiloptixlab_tpu_torch.passes import PTPass
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.scene.instanced_grid import write_instanced_scene
    from pupiloptixlab_tpu_torch.system import System

    xml = write_instanced_scene(tmp / "instanced", SKY, INST_N, INST_GRID, *FILM, max_depth=4)
    system = System(device=DEV)
    pt = PTPass()
    system.add_pass(pt)
    t0 = time.perf_counter()
    require(system.set_scene(xml), "instanced: set_scene failed")
    load_s = time.perf_counter() - t0
    config = pt._config
    data, _ = system.world.get_scene_data()
    cam = system.world.get_camera_block()
    tr = data.tris
    tb = table_bytes(tr)
    log(f"  instanced: set_scene {load_s:.2f} s: {tr.packed.shape[0]} unique rows, "
        f"{tr.leaf_start.shape[0]} world leaves of {config.bvh_tcl} rows, "
        f"{tr.inst_w2o.shape[0]} instances, {config.bvh_nodes} nodes, depth {tr.bvh_depth}, "
        f"table bytes {tb}")
    require(config.instanced and type(system.world._refit).__name__ == "InstRefitData"
            and (config.width, config.height, config.max_depth) == (*FILM, 4),
            "instanced: expected instanced tables with their refit records at depth 4")
    n = config.width * config.height
    iters, warm = 2, 1
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system.run(max_frames=warm)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    system.run(max_frames=iters)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    frame = system.buffers["pt frame"].array
    mean = float(frame.mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rays_n = n * (1 + 2 * (config.max_depth - 1))
    log(f"  instanced System: warm-up {warm_ms:.1f} ms, {dt * 1e3:.2f} ms/frame "
        f"({1e3 / (dt * 1e3):.2f} frames/s), {rays_n / dt / 1e6:.2f} Mray/s, mean {mean:.5f}, "
        f"peak {peak_gb:.2f} GB, launches over {warm + iters} frames {launches}")
    require(bool(torch.isfinite(frame).all()) and mean > 0.0, "instanced: frame is not finite")
    require(all(launches[k] > 0 for k in INST_PATH)
            and all(launches[k] == 0 for k in ("bvh_closest", "bvh_anyhit", "sweep_closest",
                                                "sweep_anyhit")),
            f"instanced: the path must launch K7, K8, K3, K4 and no other traversal: {launches}")
    rec = {"set_scene_s": load_s, "ms_per_frame": dt * 1e3, "frames_per_s": 1.0 / dt,
           "mrays_per_s": rays_n / dt / 1e6, "warmup_ms": warm_ms, "mean": mean,
           "peak_gb": peak_gb, "frames": warm + iters, "launches": launches,
           "unique_rows": tr.packed.shape[0], "world_leaves": tr.leaf_start.shape[0],
           "instances": tr.inst_w2o.shape[0], "bvh_nodes": config.bvh_nodes,
           "bvh_depth": tr.bvh_depth, "bvh_tcl": config.bvh_tcl, "table_bytes": tb}

    rays = main_path_rays(data, config, cam)
    lanes = pick_lanes(n, tr.packed.device)
    ks = results["kernels"]
    check_inst_traversal(data, config, rays, lanes, ks, bounds)
    rec["subleaf"] = check_subleaf_gates(data, config, cam, rays, lanes[:INST_MODE_LANES])
    check_gathers("instanced", rays["gathers"], ks["gather_planes"], bounds["gather_planes"])
    check_counts("instanced", {**rays["counts"], **env_cases(data, n, seed=3)},
                 ks["count_less"], bounds["count_less"])
    del rays

    # the same scene's baked tables on K1/K2 at equal seeds
    t0 = time.perf_counter()
    baked, bconfig = flatten_scene(system.world.scene, allow_instanced=False, device=DEV)
    baked_s = time.perf_counter() - t0
    require(not bconfig.instanced and bconfig.max_depth == config.max_depth,
            "the baked twin must not be instanced")
    frames = {}
    for label, d, c in (("instanced", data, config), ("baked", baked, bconfig)):
        accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
        _, bufs = render_frame(d, cam, 0, 0, accum, c)
        frames[label] = bufs["frame"].cpu().numpy()
    diff = np.abs(frames["instanced"] - frames["baked"]).max(axis=-1)
    q995 = float(np.quantile(diff, 0.995))
    ratio = float(frames["instanced"].mean() / frames["baked"].mean())
    log(f"  instanced vs baked ({bconfig.tri_count} rows flattened in {baked_s:.1f} s), "
        f"seed 0 at 1920x1080: 99.5% quantile of |diff| {q995:.3e}, mean ratio {ratio:.6f}")
    require(q995 < 2e-3 and abs(ratio - 1.0) < 2e-3,
            "instanced and baked frames disagree (99.5% within 2e-3, mean ratio within 2e-3)")
    rec["vs_baked"] = {"baked_rows": bconfig.tri_count, "baked_flatten_s": baked_s,
                       "q995_abs_diff": q995, "mean_ratio": ratio}
    del baked, frames
    system.destroy()
    torch.cuda.empty_cache()

    # card against CPU at a small film of the same scene
    small = write_instanced_scene(tmp / "instanced_small", SKY, INST_N, INST_GRID, 32, 18,
                                  max_depth=4)
    seqs = {}
    for dev in (DEV, "cpu"):
        d, c, cm = load_tables(small, 32, 18, dev)
        m = c.width * c.height
        accum = torch.zeros((m, 3), dtype=torch.float32, device=dev)
        seqs[dev] = []
        for i in range(2):
            _, bufs = render_frame(d, cm, i, i, accum, c)
            seqs[dev].append({k: v.cpu().numpy().copy() for k, v in bufs.items()})
    worst = {"rel_mse": 0.0, "frac_within_1e-4": 1.0, "normal_max": 0.0, "albedo_max": 0.0}
    for i, (g, c) in enumerate(zip(seqs[DEV], seqs["cpu"])):
        compare_frames(f"instanced 32x18 seed {i}", g, c, worst)
    rec["parity"] = worst
    results["instanced"] = rec
    return launches, xml


def _leaf_boxes(tris) -> dict:
    """{(row start, instance): box} of every world leaf of an instanced tree."""
    child = tris.bvh_child.cpu().numpy()
    boxes = tris.bvh_boxes.cpu().numpy()
    start, inst = tris.leaf_start.cpu().numpy(), tris.leaf_inst.cpu().numpy()
    return {(int(start[-c - 1]), int(inst[-c - 1])): boxes[slot, 0:6]
            for slot, c in enumerate(child) if c < 0}


REFIT_K7_LANES = 8192  # K7 (K1) against the plain scan (brute sweep) after phase 12's edits


def check_subleaf_after_refit(data0, data1, config, cam) -> dict:
    """After phase 12's mesh_env edit: the baked refit keeps the sub-leaf
    row order, and its group boxes equal a build from the moved rows on
    live rows: each group's box holds its live rows' vertices (float64,
    numpy) and is no looser than the margin (``SUBLEAF_PAD`` of the box,
    ``SCENE_PAD`` of the table's extent, one float32 rounding), a group
    without a live row holds the never-box. Then K1 against the brute
    sweep on ``REFIT_K7_LANES`` seeded lanes of the edited scene's primary
    rays."""
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data1.tris
    tcl = config.bvh_tcl
    p = tr.packed.cpu().numpy()[:, 0:9].astype(np.float64)
    boxes = tr.subleaf_boxes.cpu().numpy().astype(np.float64)
    live = (p[:, 3:6] != 0).any(1) & (p[:, 6:9] != 0).any(1)
    verts = np.stack([p[:, 0:3], p[:, 0:3] + p[:, 3:6], p[:, 0:3] + p[:, 6:9]], 1)
    extent = float(np.abs(verts[live]).max())
    # table row of each slot, group-major: leaf start + the leaf-local order
    rows = (np.arange(p.shape[0]) // tcl * tcl
            + tr.subleaf_rows.cpu().numpy().astype(np.int64))
    lv = live[rows].reshape(-1, tcl // 8)
    vg = verts[rows].reshape(-1, tcl // 8, 3, 3)
    lo = np.where(lv[:, :, None, None], vg, np.inf).min((1, 2))
    hi = np.where(lv[:, :, None, None], vg, -np.inf).max((1, 2))
    some = lv.any(1)
    lo, hi, box = lo[some], hi[some], boxes[some]
    big = np.maximum(np.abs(lo), np.abs(hi)).max(1, keepdims=True)
    margin = bt.SUBLEAF_PAD * big + bt.SCENE_PAD * extent
    margin = margin + 2 * np.spacing(np.float32(big + margin)).astype(np.float64)
    rec = {"order_kept": tr.subleaf_rows is data0.tris.subleaf_rows,
           "boxes_rebuilt": not torch.equal(tr.subleaf_boxes, data0.tris.subleaf_boxes),
           "live_groups": int(some.sum()),
           "boxes_hold_rows": bool((box[:, 0:3] <= lo).all() and (box[:, 3:6] >= hi).all()),
           "boxes_within_margin": bool((lo - box[:, 0:3] <= margin).all()
                                       and (box[:, 3:6] - hi <= margin).all()),
           "empty_groups_never": bool((boxes[~some, 0:6] == np.float32(1e30)).all())}
    planes = primary_planes(config, cam)
    lanes = pick_lanes(planes[0].shape[0], DEV)[:REFIT_K7_LANES]
    sub = [x[lanes].contiguous() for x in planes]
    t, i = bt.bvh_closest(*sub, *bvh_tables(tr), tcl=tcl, depth=tr.bvh_depth)
    tp, ip = bt.plain_closest(*sub, tr.packed)
    rec.update(k1_lanes=lanes.numel(), k1_hits=int((ip >= 0).sum()),
               k1_t_off=int((t != tp).sum()), k1_rows_off=int((i != ip).sum()))
    require(all(v for k, v in rec.items() if k in ("order_kept", "boxes_rebuilt",
                                                   "boxes_hold_rows", "boxes_within_margin",
                                                   "empty_groups_never"))
            and rec["k1_hits"] > 0 and rec["k1_t_off"] == 0 and rec["k1_rows_off"] == 0,
            f"the baked refit's sub-leaf table or K1 after the edit is off: {rec}")
    return rec


def check_k7_after_edit(data, config, cam) -> dict:
    """K7 on ``REFIT_K7_LANES`` seeded lanes of the edited instanced scene's
    primary rays (the refit's tables: moved and hidden instances, the
    sub-leaf boxes kept) against the plain leaf scan."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    planes = primary_planes(config, cam)
    lanes = pick_lanes(planes[0].shape[0], DEV)[:REFIT_K7_LANES]
    sub = [p[lanes].contiguous() for p in planes]
    t, i, leaf = bt.bvh_closest_inst(*sub, *inst_tables(tr), tcl=config.bvh_tcl,
                                     depth=tr.bvh_depth)
    tp, ip, lp = bt.plain_closest_inst(*sub, tr.packed, tr.leaf_start, tr.leaf_inst,
                                       tr.inst_w2o, tcl=config.bvh_tcl)
    rec = {"lanes": lanes.numel(), "hits": int((ip >= 0).sum()),
           "t_off": int((t != tp).sum()), "rows_off": int(((i != ip) | (leaf != lp)).sum())}
    require(rec["hits"] > 0 and rec["t_off"] == 0 and rec["rows_off"] == 0,
            f"K7 disagrees with the plain leaf scan after the edit: {rec}")
    return rec


def phase_refit(inst_xml, results):
    """Phase 12: an edit through World.render_objects refits on the card
    without a flatten, and gives a fresh flatten's tables on live rows."""
    import dataclasses

    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.flatten import flatten_scene
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.scene import load_scene
    from pupiloptixlab_tpu_torch.utils.math import Transform
    from pupiloptixlab_tpu_torch.world import world as world_mod

    out = {}
    real = world_mod.flatten_scene
    for label, xml, (moved, hidden) in (("instanced", inst_xml, (3, 5)),
                                        ("mesh_env", MESH_ENV, (0, 1))):
        calls = []

        def counting(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        world_mod.flatten_scene = counting
        try:
            w = world_mod.World(device=DEV)
            w.set_scene(load_scene(xml))
            t0 = time.perf_counter()
            data0, config0 = w.get_scene_data()
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            ros = w.render_objects
            ros[moved].apply_transform(Transform().translate(0.4, 0.25, -0.3))
            ros[hidden].set_visible(False)
            t0 = time.perf_counter()
            data1, config1 = w.get_scene_data()
            torch.cuda.synchronize()
            refit_s = time.perf_counter() - t0
        finally:
            world_mod.flatten_scene = real
        t0 = time.perf_counter()
        fresh, fconfig, frec = flatten_scene(w.scene, return_refit=True, device=DEV)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        # the refit keeps its tree; a fresh flatten builds one of its own
        same_config = dataclasses.replace(fconfig, bvh_nodes=config0.bvh_nodes) == config0
        require(len(calls) == 1 and config1 == config0 and same_config,
                f"{label}: the edit must refit, not flatten ({len(calls)} flatten calls), "
                f"keeping the configuration: {config1} / {fconfig}")
        kind = type(w._refit).__name__
        if config0.instanced:
            require(kind == "InstRefitData" and data1.tris.packed is data0.tris.packed,
                    "instanced: the refit must keep the object-space tables")
            same = all(torch.equal(getattr(data1.tris, f), getattr(fresh.tris, f))
                       for f in ("packed", "attrs", "inst_w2o", "inst_packed"))
            # world leaves by (row start, instance): the refit keeps its tree,
            # the fresh flatten builds a new one
            a, b = _leaf_boxes(data1.tris), _leaf_boxes(fresh.tris)
            live = [k for k in a if a[k][0] < 1e30]
            la = np.stack([a[k] for k in live])
            lb = np.stack([b[k] for k in live])
            ulp = float(np.max(np.abs(la - lb) / np.spacing(np.abs(lb))))
            dead = sum(1 for k in a if k[1] == hidden)  # mesh instances = scene instances here
            # the sub-leaf boxes are object-space: the refit keeps them as they are
            sub_kept = (data1.tris.subleaf_boxes is data0.tris.subleaf_boxes
                        and torch.equal(data1.tris.subleaf_boxes, fresh.tris.subleaf_boxes))
            ok = (same and sub_kept and a.keys() == b.keys() and ulp <= 1.0
                  and len(live) == len(a) - dead)
            err = {"tables_equal": same, "subleaf_kept": sub_kept, "live_leaves": len(live),
                   "leaf_box_max_ulp": ulp}
        else:
            require(kind == "RefitData", f"{label}: expected baked refit records")

            def by_key(d, rec):
                key = rec.tri_inst.astype(np.int64) * (1 << 32) + rec.u_row
                keep = rec.tri_valid & (rec.tri_inst != hidden)
                order = np.argsort(key[keep])
                return (d.tris.packed.cpu().numpy()[keep][order],
                        d.tris.attrs.cpu().numpy()[keep][order])

            (gp, ga), (fp, fa) = by_key(data1, w._refit), by_key(fresh, frec)
            dp = float(np.abs(gp[:, 0:9] - fp[:, 0:9]).max())
            dn = float(np.abs(ga[:, 0:9] - fa[:, 0:9]).max())
            ok = gp.shape == fp.shape and dp <= 2e-6 and dn <= 1e-6 and np.array_equal(
                ga[:, 9:17], fa[:, 9:17])
            err = {"live_rows": int(gp.shape[0]), "max_abs_p0_e1_e2": dp, "max_abs_normal": dn}
        cam = w.get_camera_block()
        m = config1.width * config1.height
        accum = torch.zeros((m, 3), dtype=torch.float32, device=DEV)
        _, bufs = render_frame(data1, cam, 0, 0, accum, config1)
        finite = bool(torch.isfinite(bufs["frame"]).all())
        if config0.instanced:
            err["k7_after_edit"] = check_k7_after_edit(data1, config1, cam)
        else:
            err["subleaf_after_edit"] = check_subleaf_after_refit(data0, data1, config1, cam)
        log(f"  refit {label} ({kind}): first flatten {load_s:.3f} s, refit {refit_s * 1e3:.2f} "
            f"ms, fresh flatten of the edited scene {fresh_s:.3f} s, flatten calls "
            f"{len(calls)}, tree nodes kept {config1.bvh_nodes} (fresh {fconfig.bvh_nodes}), "
            f"against the fresh flatten {err}, frame after the edit finite {finite}")
        require(ok and finite, f"refit {label}: tables disagree with a fresh flatten")
        out[label] = {"records": kind, "flatten_s": load_s, "refit_ms": refit_s * 1e3,
                      "fresh_flatten_s": fresh_s, "bvh_nodes": config1.bvh_nodes,
                      "fresh_bvh_nodes": fconfig.bvh_nodes, **err}
    results["refit"] = out


def denoise_inputs(width: int, height: int, device, seed: int = 3):
    """bench.py:89-94's denoiser inputs: colour and albedo uniform in [0, 1),
    unit normals, from a numpy seed; (h, w, 3) each."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    color = rs.rand(height, width, 3).astype(np.float32)
    albedo = rs.rand(height, width, 3).astype(np.float32)
    nr = rs.randn(height, width, 3).astype(np.float32)
    nr /= np.maximum(np.linalg.norm(nr, axis=-1, keepdims=True), 1e-9)
    return tuple(torch.from_numpy(x).to(device) for x in (color, albedo, nr))


def plain_denoise(color, albedo, normal, guided: bool):
    """The plain filter (the reference's _atrous_denoise_jnp) on the
    tensors' device, at the denoiser's default sigmas."""
    from pupiloptixlab_tpu_torch.denoise import atrous as ta

    return ta._atrous_denoise(color, albedo, normal, None, (), DENOISE_ITERS, guided,
                              guided, 0.35, 0.15, 0.25, 4.0)[0]


def check_atrous(label, color, albedo, normal, guided, k9, bound):
    """K9 at the 5 steps of a denoise of one (h, w, 3) image: each launch
    against its plain version on the same input planes (atol 2e-6, rtol
    1e-5) and timed beside it, then the 5-launch denoise against the plain
    filter. The launch times, plain times and bounds add to ``k9`` and
    ``bound``; returns the record."""
    import torch

    from pupiloptixlab_tpu_torch.denoise import atrous_kernel as tk

    flags = dict(use_albedo=guided, use_normal=guided)
    a, n = tk.planes_of(albedo), tk.planes_of(normal)
    x = tk.planes_of(color)
    h, w = x.shape[1:]
    rec = {"shape": [h, w], "guided": guided, "launch_ms": [], "plain_launch_ms": [],
           "bound_ms": [], "max_abs_err": 0.0}
    for it in range(DENOISE_ITERS):
        step = 1 << it
        got = tk.atrous_iter(x, a, n, step, **flags)
        want = tk.atrous_iter_plain(x, a, n, step, **flags)
        err = float((got - want).abs().max())
        close = bool(torch.allclose(got, want, atol=2e-6, rtol=1e-5))
        ms = cuda_time_ms(lambda: tk.atrous_iter(x, a, n, step, **flags), reps=5)
        plain_ms = cuda_time_ms(lambda: tk.atrous_iter_plain(x, a, n, step, **flags), reps=2)
        # colour in and out, plus the guide planes the flags compile in
        planes = 3 + 3 * flags["use_albedo"] + 3 * flags["use_normal"] + 3
        b_ms, by = bound.add(planes * 4 * h * w,
                             h * w * (25 * ATROUS_TAP_FLOPS[guided] + ATROUS_PIXEL_FLOPS))
        log(f"  K9 {label} step {step}: max |diff| {err:.3e}, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms ({by})")
        require(close, f"K9 {label} step {step}: kernel disagrees with its plain version")
        rec["launch_ms"].append(ms)
        rec["plain_launch_ms"].append(plain_ms)
        rec["bound_ms"].append(b_ms)
        rec["bound_by"] = by
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        x = want
    got = tk.atrous_denoise_cuda(color, albedo, normal, **flags)
    want = plain_denoise(color, albedo, normal, guided)
    err = float((got - want).abs().max())
    denoise_ms = cuda_time_ms(lambda: tk.atrous_denoise_cuda(color, albedo, normal, **flags),
                              reps=3)
    plain_ms = cuda_time_ms(lambda: plain_denoise(color, albedo, normal, guided), reps=1)
    log(f"  K9 {label} denoise ({DENOISE_ITERS} launches): max |diff| {err:.3e} against the "
        f"plain filter, {denoise_ms:.3f} ms, plain {plain_ms:.1f} ms")
    require(bool(torch.allclose(got, want, atol=2e-6, rtol=1e-5)),
            f"K9 {label}: the denoise disagrees with the plain filter")
    rec.update(denoise_ms=denoise_ms, plain_denoise_ms=plain_ms, denoise_max_abs_err=err)
    k9["ms"] += sum(rec["launch_ms"])
    k9["plain_ms"] += sum(rec["plain_launch_ms"])
    k9["max_abs_err"] = max(k9["max_abs_err"], rec["max_abs_err"], err)
    k9.update(bound.fields())
    return rec


def phase_denoise_kernel(results):
    """K9 alone on bench.py's inputs at 1920x1080, guided and unguided,
    outside the kernels line's sums; then every other mode of the
    denoiser once at 256x144 on the card against the same call on the CPU."""
    import torch

    from pupiloptixlab_tpu_torch.denoise import Denoiser, DenoiserMode, denoise
    from pupiloptixlab_tpu_torch.denoise import atrous as ta

    out = {}
    color, albedo, normal = denoise_inputs(*FILM, DEV)
    scratch = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for guided in (True, False):
        out["guided" if guided else "unguided"] = check_atrous(
            "bench " + ("guided" if guided else "unguided"), color, albedo, normal, guided,
            scratch, Bound())
    del color, albedo, normal

    w, h = MODES_FILM
    mode = DenoiserMode.USE_ALBEDO | DenoiserMode.USE_NORMAL
    cases = {}
    for dev in (DEV, "cpu"):
        c, a, n = denoise_inputs(w, h, dev, seed=5)
        c_prev, _, _ = denoise_inputs(w, h, dev, seed=6)
        a_hi, n_hi = denoise_inputs(2 * w, 2 * h, dev, seed=7)[1:]
        g = torch.Generator(device="cpu").manual_seed(8)
        var = (torch.rand((h, w), generator=g) * 0.05).to(dev)
        aov = torch.rand((h, w, 3), generator=g).to(dev)
        motion = (torch.randn((h, w, 2), generator=g) * 3.0).to(dev)
        res = {}
        res["variance"] = ta.atrous_denoise(c, a, n, variance=var)
        res["aov"], (res["aov_layer"],) = ta.atrous_denoise(c, a, n, aovs=(aov,))
        res["temporal_motion"] = denoise(c, a, n, previous=c_prev,
                                         mode=mode | DenoiserMode.TEMPORAL, motion=motion)
        res["upscale_guided"] = denoise(c, a, n, mode=mode | DenoiserMode.UPSCALE_2X,
                                        albedo_hi=a_hi, normal_hi=n_hi)
        tiled = Denoiser(mode | DenoiserMode.TILED)
        tiled.setup(w, h)
        tiled.tile_size, tiled.overlap = 64, 16
        res["tiled"] = tiled.execute({"input": c, "albedo": a, "normal": n})
        cases[dev] = {k: v.cpu() for k, v in res.items()}
    modes = {}
    for name, got in cases[DEV].items():
        want = cases["cpu"][name]
        err = float((got - want).abs().max())
        log(f"  denoiser {name} {w}x{h} {tuple(got.shape)}, card against CPU: max |diff| "
            f"{err:.3e}")
        require(got.shape == want.shape and bool(torch.isfinite(got).all())
                and bool(torch.allclose(got, want, **MODES_TOL)),
                f"denoiser {name}: card and CPU disagree (atol 1e-5, rtol 1e-5)")
        modes[name] = err
    out["modes_max_abs_err"] = modes
    results["denoise_kernel"] = out


def phase_denoise_system(tmp, results, k9, bound):
    """System + PTPass + DenoisePass on mesh_env at 1920x1080, depth 4:
    frames without the denoiser, then with it (the counts set to 0 just
    before and read just after); pt denoised against the plain filter on
    the same frame's buffers; K9 on those buffers against its plain
    version; a 32x18 film on the card against the CPU."""
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.passes import DenoisePass, PTPass
    from pupiloptixlab_tpu_torch.system import System

    system = System()
    pt, dn = PTPass(), DenoisePass()
    system.add_pass(pt)
    system.add_pass(dn)
    t0 = time.perf_counter()
    require(system.set_scene(scene_copy(MESH_ENV, *FILM, tmp)), "mesh_env: set_scene failed")
    load_s = time.perf_counter() - t0
    config = pt._config
    require(str(system.device).startswith("cuda") and config.bvh_nodes > 0
            and not config.instanced and (config.width, config.height, config.max_depth)
            == (*FILM, 4), "mesh_env_denoise: expected the BVH route at 1920x1080 depth 4")
    n = config.width * config.height
    rays = n * (1 + 2 * (config.max_depth - 1))

    def frames(warm, iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(max_frames=warm)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        system.run(max_frames=iters)
        torch.cuda.synchronize()
        return warm_ms, (time.perf_counter() - t0) / iters * 1e3

    dn.enabled = False
    _, plain_frame_ms = frames(1, 2)
    dn.enabled = True
    warm, iters = 1, 2
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    warm_ms, frame_ms = frames(warm, iters)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_frame = launches["atrous_iter"] / (warm + iters)
    dn_ms = cuda_time_ms(dn.on_run, reps=3)
    log(f"  mesh_env_denoise: set_scene {load_s:.2f} s; without the denoiser "
        f"{plain_frame_ms:.2f} ms/frame, with it {frame_ms:.2f} ms/frame "
        f"({rays / frame_ms / 1e3:.2f} Mray/s; warm-up {warm_ms:.1f} ms), DenoisePass "
        f"{dn_ms:.3f} ms a frame on the card, K9 {per_frame:g} launches a frame, peak "
        f"{peak_gb:.2f} GB, launches over {warm + iters} frames {launches}")
    require(launches["atrous_iter"] == DENOISE_ITERS * (warm + iters)
            and all(launches[k] > 0 for k in BVH_PATH),
            f"mesh_env_denoise: K9 must launch {DENOISE_ITERS} times a frame beside K1-K4: "
            f"{launches}")
    bm = system.buffers
    h, w = config.height, config.width
    color = bm["pt frame"].array[:, :3].reshape(h, w, 3).contiguous()
    albedo = bm["pt albedo"].array.reshape(h, w, 3).contiguous()
    normal = bm["pt normal"].array.reshape(h, w, 3).contiguous()
    got = bm["pt denoised"].array.reshape(h, w, 3)
    want = plain_denoise(color, albedo, normal, True)
    err = float((got - want).abs().max())
    std_in, std_out = float(color.std()), float(got.std())
    log(f"  pt denoised against the plain filter on the same buffers: max |diff| {err:.3e}; "
        f"std {std_in:.5f} -> {std_out:.5f}")
    require(bool(torch.isfinite(got).all())
            and bool(torch.allclose(got, want, atol=2e-6, rtol=1e-5)),
            "mesh_env_denoise: pt denoised disagrees with the plain filter")
    require(std_out < std_in, "mesh_env_denoise: denoising did not lower the std")
    rec = {"set_scene_s": load_s, "ms_per_frame": frame_ms, "ms_per_frame_without": plain_frame_ms,
           "denoise_pass_ms": dn_ms, "mrays_per_s": rays / frame_ms / 1e3,
           "warmup_ms": warm_ms, "peak_gb": peak_gb, "frames": warm + iters,
           "launches": launches, "k9_per_frame": per_frame, "vs_plain_max_abs_err": err,
           "std_noisy": std_in, "std_denoised": std_out}
    rec["k9"] = check_atrous("mesh_env frame", color, albedo, normal, True, k9, bound)
    system.destroy()
    del system, color, albedo, normal, got, want
    torch.cuda.empty_cache()

    # a 32x18 film on the card and on the CPU, two frames each
    small = scene_copy(MESH_ENV, 32, 18, tmp)
    seqs = {}
    for dev in (DEV, "cpu"):
        sysd = System(device=dev)
        sysd.add_pass(PTPass())
        sysd.add_pass(DenoisePass())
        require(sysd.set_scene(small), "mesh_env 32x18: set_scene failed")
        seqs[dev] = []
        for _ in range(2):
            sysd.run(max_frames=1)
            seqs[dev].append({k.split()[1]: sysd.buffers[k].array.cpu().numpy().copy()
                              for k in ("pt frame", "pt albedo", "pt normal", "pt test",
                                        "pt denoised")})
        sysd.destroy()
    worst = {"rel_mse": 0.0, "frac_within_1e-4": 1.0, "normal_max": 0.0, "albedo_max": 0.0}
    dworst = {"rel_mse": 0.0, "frac_within_1e-4": 1.0}
    for i, (g, c) in enumerate(zip(seqs[DEV], seqs["cpu"])):
        compare_frames(f"mesh_env_denoise 32x18 frame {i}", g, c, worst)
        a, b = g["denoised"], c["denoised"]
        rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
        frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
        log(f"  mesh_env_denoise 32x18 denoised {i}: rel MSE {rel:.3e}, pixels within rtol "
            f"1e-4 {frac:.4f}")
        require(rel <= 1e-5 and frac >= 0.99, "card and CPU denoised frames disagree")
        dworst["rel_mse"] = max(dworst["rel_mse"], rel)
        dworst["frac_within_1e-4"] = min(dworst["frac_within_1e-4"], frac)
    rec["parity"], rec["parity_denoised"] = worst, dworst
    results["mesh_env_denoise"] = rec
    return launches


@contextlib.contextmanager
def matmul_form(on: bool):
    """PUPIL_MXU_MT as the port reads it: into ``intersect.MXU_MT``, a
    module constant taken from the environment at import (as the
    reference's ``MXU_MT``), set here for the duration."""
    from pupiloptixlab_tpu_torch.accel import intersect

    old = intersect.MXU_MT
    intersect.MXU_MT = on
    try:
        yield
    finally:
        intersect.MXU_MT = old


MT_PATH = ("bvh_closest_mt", "bvh_anyhit", "gather_planes", "count_less")


def compare_mt_k1(tri, center, planes, t_k, i_k, t1, i1) -> dict:
    """K10 against K1 on the same rays and tables. ``rows_off``: lanes on
    another row. On the lanes of one row, |t_K10 - t_K1| is held to the
    reference's rtol 3e-5 + atol 1e-5 (tests/test_bvh.py:167-170) plus the
    linear form's cancellation term
        MT_CANCEL_K * u * (|o - c| + |p0 - c| + t |d|) * |e1| |e2| / |det|
    with u = 2^-24: t*det = (o - c).N - (p0 - c).N and det = -d.N subtract
    products of that size, each rounded in float32 (the recentring, each
    component of N = e1 x e2, the 10-term sums), so a near, grazing hit
    loses relative precision; Moller-Trumbore's t carries a term of the
    same form. ``t_off`` counts the lanes beyond the reference's limits
    alone, ``t_over`` those beyond the whole limit; each t_off lane is
    returned in full (``t_off_lanes``, with the row, the centre and t in
    float64 from the same float32 inputs) for tests/test_torch_mt.py."""
    import torch

    same = (i_k == i1) & (i1 >= 0)
    lanes = torch.nonzero(same).squeeze(1)
    o, d = (torch.stack([p[lanes] for p in planes[k:k + 3]], 1).double() for k in (0, 3))
    row = tri[i1[lanes].long()]
    p0, e1, e2 = (row[:, k:k + 3].double() for k in (0, 3, 6))
    det = (e1 * torch.linalg.cross(d, e2)).sum(1)
    t64 = (e2 * torch.linalg.cross(o - p0, e1)).sum(1) / det
    c = center.double()
    scale = (((o - c).norm(dim=1) + (p0 - c).norm(dim=1) + t64.abs() * d.norm(dim=1))
             * e1.norm(dim=1) * e2.norm(dim=1) / det.abs())
    tk, tc = t_k[lanes].double(), t1[lanes].double()
    dt = (tk - tc).abs()
    ref_lim = 1e-5 + 3e-5 * tc.abs()
    lim = ref_lim + MT_CANCEL_K * 2.0 ** -24 * scale
    off = dt > ref_lim
    out = {"rows_off": int((i_k != i1).sum()), "t_off": int(off.sum()),
           "t_over": int((dt > lim).sum()),
           "max_dt_over_limit": float((dt / lim).max()) if lanes.numel() else 0.0,
           "max_rel_dt_same_row": float((dt / tc.abs()).max()) if lanes.numel() else 0.0}
    if out["t_off"]:
        k = torch.nonzero(off).squeeze(1)[:MT_DUMP_LANES]
        out["t_off_k10_err_f64"] = float((tk[off] - t64[off]).abs().max())
        out["t_off_k1_err_f64"] = float((tc[off] - t64[off]).abs().max())
        out["center"] = [float(x) for x in center]
        out["t_off_lanes"] = [{
            "o": [float(x) for x in o[j]], "d": [float(x) for x in d[j]],
            "tmin": float(planes[6][lanes[j]]), "tmax": float(planes[7][lanes[j]]),
            "row": int(i1[lanes[j]]), "tri": [float(x) for x in row[j, 0:9]],
            "t_k10": float(tk[j]), "t_k1": float(tc[j]), "t_f64": float(t64[j]),
            "limit": float(lim[j])} for j in k.tolist()]
    return out


def phase_mt32(results, k10, bound):
    """mesh_env flattened under PUPIL_TCL=32 at 1920x1080 with PUPIL_MXU_MT:
    K10 against its plain version on 65,536-lane subsets and against K1 on
    the same tables at full N; render_frame with the counts set to 0 just
    before and read just after; the frame against K1's at equal seed. The
    bound counts one row test a hit (MT_FLOPS_LINEAR), as K1's does,
    whatever the kernel tests."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.accel.intersect import uses_mt
    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    with pupil_env("PUPIL_TCL", "32"):
        data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
    tris = data.tris
    tabs = (tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes)
    kw = dict(tcl=config.bvh_tcl, depth=tris.bvh_depth)
    with matmul_form(True):
        route = uses_mt(tris, config)
    log(f"  mesh_env under PUPIL_TCL=32: {tris.packed.shape[0]} rows, tcl {config.bvh_tcl}, "
        f"{config.bvh_nodes} nodes, depth {tris.bvh_depth}; linear-form route {route}")
    require(config.bvh_tcl == 32 and route, "mesh_env_mt32: expected the linear-form route")
    n = config.width * config.height
    lanes = pick_lanes(n, tris.packed.device)
    rec = {"rows": tris.packed.shape[0], "bvh_nodes": config.bvh_nodes,
           "bvh_depth": tris.bvh_depth, "calls": {}}
    with matmul_form(True):
        rays = main_path_rays(data, config, cam)
        for label in ("primary", "bounce"):
            full = planes_of(rays[label])
            t_k, i_k = bt.bvh_closest_mt(*full, *tabs, **kw)
            sub = planes_of(rays[label], lanes)
            (t_p, i_p), plain_ms = host_timed(lambda: bt.plain_closest_mt(*sub, tris.packed))
            mism = int((i_k[lanes] != i_p).sum())
            bit_t = bool(torch.equal(t_k[lanes], t_p))
            hit = i_p >= 0
            err = float((t_k[lanes][hit] - t_p[hit]).abs().max()) if bool(hit.any()) else 0.0
            ms = cuda_time_ms(lambda: bt.bvh_closest_mt(*full, *tabs, **kw), reps=5)
            # K1 on the same tables and rays at full N
            t1, i1 = bt.bvh_closest(*full, *bvh_tables(tris), **kw)
            k1_ms = cuda_time_ms(lambda: bt.bvh_closest(*full, *bvh_tables(tris), **kw), reps=5)
            hits1 = int((i1 >= 0).sum())
            vs_k1 = compare_mt_k1(tris.packed, bt.mt_tables(tris.packed)[1], full, t_k,
                                  i_k, t1, i1)
            live = int((full[7] > full[6]).sum())
            b_ms, by = bound.add(nbytes(*full, *tabs, t_k, i_k),
                                 live * 8 * SLAB_FLOPS + int((i_k >= 0).sum()) * MT_FLOPS_LINEAR)
            log(f"  K10 {label}: {int(hit.sum())}/{lanes.numel()} hits, row mismatches {mism}, "
                f"t bit-equal {bit_t}; kernel {ms:.3f} ms at N={n}, plain {plain_ms:.1f} ms "
                f"at N={lanes.numel()}, bound {b_ms:.4f} ms ({by}); against K1 (tcl 32, "
                f"{k1_ms:.3f} ms) of {hits1} hits: "
                f"{ {k: v for k, v in vs_k1.items() if k != 't_off_lanes'} }")
            require(mism == 0 and bit_t, f"K10 {label}: kernel disagrees with its plain version")
            require(vs_k1["rows_off"] + vs_k1["t_off"] <= 1e-4 * hits1,
                    f"K10 {label}: disagrees with K1 on more than 1e-4 of the hits (row, or t "
                    "beyond rtol 3e-5 + atol 1e-5)")
            require(vs_k1["t_over"] == 0,
                    f"K10 {label}: t beyond the linear form's cancellation limit on "
                    f"{vs_k1['t_over']} lanes of one row")
            rec["calls"][label] = {
                "ms": ms, "plain_ms": plain_ms, "plain_n": lanes.numel(), "bound_ms": b_ms,
                "bound_by": by, "hits": int(hit.sum()), "mismatches": mism, "k1_ms": k1_ms,
                "hits_k1": hits1, "vs_k1": vs_k1}
            k10["ms"] += ms
            k10["plain_ms"] += plain_ms
            k10["max_abs_err"] = max(k10["max_abs_err"], err)
            k10["mismatches"] += mism
        k10.update(bound.fields())
        del rays
        rec["tc_gate"] = check_mt_tc_gate(data, config, cam)
        launches = phase_frame(data, config, cam, results, label="mesh_env_mt32",
                               path=MT_PATH, absent=("bvh_closest",))
    # the frame against K1's on the same tables at equal seed
    bufs = {}
    for on in (True, False):
        with matmul_form(on):
            accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
            _, b = render_frame(data, cam, 0, 0, accum, config)
            bufs[on] = {k: v.cpu().numpy().copy() for k, v in b.items()}
    worst = {"rel_mse": 0.0, "frac_within_1e-4": 1.0, "normal_max": 0.0, "albedo_max": 0.0}
    compare_frames("mesh_env_mt32 frame against K1's, seed 0", bufs[True], bufs[False], worst)
    rec["vs_k1_frame"] = worst
    results["mesh_env_mt32"] = rec
    del data
    torch.cuda.empty_cache()
    return launches


PAR_TILES = 64       # whole 1024-lane tiles K11's counts are held on (65,536 lanes)
RING_SHARDS = 4      # simulated ranks of phase 16's ring rounds
BALANCED_PATH = ("bvh_closest_count", "bvh_closest", "bvh_anyhit", "gather_planes",
                 "count_less")


def primary_planes(config, cam, seed: int = 0):
    """The frame's primary rays in its lane order at ``seed`` as ray planes
    (render_sample's and balance.tile_costs's)."""
    from pupiloptixlab_tpu_torch.render.integrator import lane_pixels, primary_rays

    return planes_of(primary_rays(cam, config, seed, lane_pixels(config, device=DEV))[1])


def ties_only(planes, tri, t, rows_a, rows_b) -> dict:
    """Lanes where two closest-hit results give other rows at bit-equal t:
    each is an exact tie when both rows hit the ray at that t."""
    from pupiloptixlab_tpu_torch.accel.sweep import mt_hit_t

    off = (rows_a != rows_b).nonzero().squeeze(1)
    if off.numel() == 0:
        return {"rows_off": 0, "ties": 0}
    ray = [p[off] for p in planes]

    def t_of(rows):
        cols = tri[rows[off].clamp(min=0).long()]
        return mt_hit_t(*ray, [cols[:, k] for k in range(9)])

    tie = (rows_a[off] >= 0) & (rows_b[off] >= 0) & (t_of(rows_a) == t[off]) & (
        t_of(rows_b) == t[off])
    return {"rows_off": int(off.numel()), "ties": int(tie.sum())}


def check_face_lanes(cam, config, tabs, kw) -> dict:
    """K1, K2 and K11 on unjittered primary rays (some run along box
    faces) against their plain versions: the lanes with a zero direction
    component, then seeded lanes up to ``SUBSET`` (whole count tiles)."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.render.camera import generate_rays
    from pupiloptixlab_tpu_torch.render.sampling import MAX_DISTANCE, RAY_OFFSET

    n = config.width * config.height
    zero = torch.zeros(n, device=DEV)
    ro, rd = generate_rays(cam, config.width, config.height, zero, zero)
    full = planes_of((ro, rd, torch.full((n,), RAY_OFFSET, device=DEV),
                      torch.full((n,), MAX_DISTANCE, device=DEV)))
    on_face = ((full[3] == 0) | (full[4] == 0) | (full[5] == 0)).nonzero().squeeze(1)
    rest = pick_lanes(n, DEV)
    rest = rest[~torch.isin(rest, on_face)][:SUBSET - on_face.numel()]
    lanes = torch.cat([on_face, rest])
    sub = [p[lanes].contiguous() for p in full]
    t1, i1 = bt.bvh_closest(*sub, *tabs, **kw)
    occ = bt.bvh_anyhit(*sub, *tabs, **kw)
    t11, i11, c11 = bt.bvh_closest(*sub, *tabs, **kw, count_iters=True)
    t_p, i_p = bt.plain_closest(*sub, tabs[0])
    occ_p = bt.plain_anyhit(*sub, tabs[0])
    t_w, i_w, c_w = bt.plain_closest_counts(*sub, *tabs, kw["tcl"])
    f = {"lanes": lanes.numel(), "on_face": on_face.numel(),
         "face_hits": int((i_p[:on_face.numel()] >= 0).sum()), "hits": int((i_p >= 0).sum()),
         "k1_t_off": int((t1 != t_p).sum()), "k1_rows_off": int((i1 != i_p).sum()),
         "k2_flags_off": int((occ != occ_p).sum()),
         "k11_lanes_off": int(((t11 != t1) | (i11 != i1)).sum()),
         "walk_lanes_off": int(((t_w != t_p) | (i_w != i_p)).sum()),
         "k11_counts_off": int((c11 != c_w).sum())}
    log(f"  (b2) unjittered rays, {f['on_face']} along box faces: {f}")
    require(on_face.numel() > 0 and f["face_hits"] > 0
            and all(v == 0 for k, v in f.items() if k.endswith("_off")),
            "K1, K2 and K11 must equal their plain versions on rays along box faces")
    return f


def frame_copy(bufs) -> dict:
    return {k: v.clone() for k, v in bufs.items()}


def frames_equal(a, b) -> bool:
    import torch

    return all(bool(torch.equal(a[k], b[k])) for k in ("frame", "albedo", "normal", "test"))


def phase_parallel(tmp, results, k11, bound):
    """Phase 16 (a)-(d): the deep soup (C.1), K11 on mesh_env at 1080p and
    on rays along box faces, the balanced frame, and the distributed code
    at world size 1 over NCCL. (e) is ``phase_ring_rounds``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.parallel import balance, ring_sweep, sharding
    from pupiloptixlab_tpu_torch.render.integrator import render_frame, render_sample
    from pupiloptixlab_tpu_torch.scene.deep_soup import soup_rays, soup_tables

    t_phase = time.perf_counter()
    rec = {}

    # (a) the deep soup: a depth-11 tree, beyond a 64-entry stack
    soup = soup_tables(device=DEV)
    tabs = soup_bvh_tables(soup)
    kw = dict(tcl=soup["tcl"], depth=soup["depth"])
    planes = soup_rays(soup["tri"], SUBSET)
    t1, i1 = bt.bvh_closest(*planes, *tabs, **kw)
    occ = bt.bvh_anyhit(*planes, *tabs, **kw)
    t_p, i_p = bt.plain_closest(*planes, soup["tri"])
    occ_p = bt.plain_anyhit(*planes, soup["tri"])
    walk = bt.tree_walk(*planes, *tabs, soup["tcl"])
    pops, deepest = walk["pops"], walk["deepest"]
    need = 7 * soup["depth"] + 1
    a = {"rows": soup["tri"].shape[0], "nodes": soup["n_nodes"], "depth": soup["depth"],
         "stack_bound": need, "deepest": deepest, "max_pops": int(pops.max()),
         "hits": int((i_p >= 0).sum()), "rows_off": int((i1 != i_p).sum()),
         "t_bit_equal": bool(torch.equal(t1, t_p)), "flags_off": int((occ != occ_p).sum())}
    log(f"  (a) deep soup: {a['rows']} rows, {a['nodes']} nodes, depth {a['depth']} (stack "
        f"bound {need} > 64: {need > 64}; fits {bt.STACK_SIZE}: {bt.stack_fits(a['depth'])}), "
        f"deepest stack the walk reached {deepest}, most pops of a ray {a['max_pops']}; "
        f"K1 {a['hits']}/{SUBSET} hits, rows off {a['rows_off']}, t bit-equal "
        f"{a['t_bit_equal']}; K2 flags off {a['flags_off']}")
    require(need > 64 and bt.stack_fits(a["depth"]) and a["rows_off"] == 0
            and a["t_bit_equal"] and a["flags_off"] == 0,
            "deep soup: K1/K2 must walk the depth-11 tree and equal their plain versions")
    a["allpass"] = allpass_gate("the deep soup", planes, tabs, kw)
    log(f"  (a) deep soup, the sub-leaf table against the all-pass table: {a['allpass']}")
    rec["deep_soup"] = a
    del soup, tabs, planes

    # (b) K11 on mesh_env's primary rays at 1080p
    data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
    tris = data.tris
    tabs = bvh_tables(tris)
    kw = dict(tcl=config.bvh_tcl, depth=tris.bvh_depth)
    n = config.width * config.height
    full = primary_planes(config, cam)
    t1, i1 = bt.bvh_closest(*full, *tabs, **kw)
    t11, i11, c11 = bt.bvh_closest(*full, *tabs, **kw, count_iters=True)
    gen = torch.Generator(device="cpu").manual_seed(16)
    tiles = torch.randperm(n // bt.COUNT_TILE, generator=gen)[:PAR_TILES].sort().values.to(DEV)
    lanes = (tiles[:, None] * bt.COUNT_TILE + torch.arange(bt.COUNT_TILE, device=DEV)).reshape(-1)
    sub = [p[lanes].contiguous() for p in full]
    (t_w, i_w, c_w), plain_ms = host_timed(lambda: bt.plain_closest_counts(*sub, *tabs,
                                                                           config.bvh_tcl))
    # K11 against K1 at full N, and its counts and lanes against the plain
    # walk on the subset's whole tiles
    err = {"t_vs_k1": float((t11 - t1).abs().max()),
           "idx_off_k1": int((i11 != i1).sum()),
           "counts_max_abs_err": int((c11[tiles] - c_w).abs().max()),
           "counts_off": int((c11[tiles] != c_w).sum()),
           "t_vs_walk": float((t11[lanes] - t_w).abs().max()),
           "lanes_off_walk": int(((t11[lanes] != t_w) | (i11[lanes] != i_w)).sum())}
    bit = bool(torch.equal(t11, t1)) and bool(torch.equal(i11, i1))
    counts_equal = bool(torch.equal(c_w, c11[tiles]))
    walk_equal = bool(torch.equal(t_w, t11[lanes])) and bool(torch.equal(i_w, i11[lanes]))
    k1_ms, k11_ms = [], []
    for count in (False, True, True, False):  # in turns: K1, K11, K11, K1
        (k11_ms if count else k1_ms).append(cuda_time_ms(
            lambda: bt.bvh_closest(*full, *tabs, **kw, count_iters=count), reps=5))
    ms, ms1 = float(np.mean(k11_ms)), float(np.mean(k1_ms))
    live = int((full[7] > full[6]).sum())
    b_ms, by = bound.add(nbytes(*full, *tabs, t11, i11, c11),
                         live * 8 * SLAB_FLOPS + int((i11 >= 0).sum()) * (18 + MT_FLOPS_CLOSEST))
    costs = c11[:, 0].double().cpu().numpy()
    q = np.percentile(costs, [0, 25, 50, 75, 100])
    spread = {"max_over_mean": float(costs.max() / costs.mean()),
              "quartiles": [float(x) for x in q], "mean": float(costs.mean()),
              "leaves_mean": float(c11[:, 1].double().mean())}
    log(f"  (b) K11 mesh_env primary N={n}: t/idx bit-equal to K1 {bit}; counts on "
        f"{PAR_TILES} tiles equal to plain_closest_counts {counts_equal} (walk t/idx equal "
        f"{walk_equal}; {err}); K11 {ms:.3f} ms ({k11_ms}) against K1 {ms1:.3f} ms ({k1_ms}), "
        f"plain {plain_ms:.1f} ms at N={lanes.numel()}, bound {b_ms:.4f} ms ({by}); tile "
        f"pops {spread}")
    require(bit and counts_equal and walk_equal,
            "K11 disagrees with K1 or with plain_closest_counts")
    k11.update(ms=ms, plain_ms=plain_ms, plain_n=lanes.numel(), k1_ms=ms1, k11_runs=k11_ms,
               k1_runs=k1_ms,
               max_abs_err=max(err["t_vs_k1"], err["t_vs_walk"], err["counts_max_abs_err"]),
               mismatches=err["idx_off_k1"] + err["counts_off"] + err["lanes_off_walk"],
               **bound.fields())
    rec["k11"] = {"k1_ms": ms1, "ms": ms, "bound_ms": b_ms, "bound_by": by,
                  "plain_ms": plain_ms, "spread": spread, "errors": err}
    del full, sub, t1, i1, t11, i11, t_w, i_w

    # (b2) unjittered primary rays, among them 1,080 whose x direction is
    # exactly 0 in the plane x = 0 that mesh_env's boxes have a face in:
    # those lanes and the rest of a seeded subset, K1, K2 and K11 against
    # the brute sweep and the plain walk
    rec["faces"] = check_face_lanes(cam, config, tabs, kw)

    # (c) the balanced frame on mesh_env at 1080p, depth 4
    def frame(perm=None):
        accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
        (_, bufs), f_ms = host_timed(lambda: render_frame(data, cam, 0, 0, accum, config,
                                                           tile_perm=perm))
        return frame_copy(bufs), f_ms

    ref, ref_ms = frame()
    torch.cuda.synchronize()
    kernels.reset_launches()
    costs = balance.tile_costs(data, cam, config)
    perms = {1: balance.balanced_tile_perm(costs, 1), 3: balance.balanced_tile_perm(costs, 3)}
    got = {d: frame(p) for d, p in perms.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    sums3 = costs[perms[3]].reshape(3, -1).sum(1)
    contiguous3 = costs.reshape(3, -1).sum(1)
    c = {"frame_ms": ref_ms, "permuted_ms": {d: g[1] for d, g in got.items()},
         "bit_equal": {d: frames_equal(g[0], ref) for d, g in got.items()},
         "perm1_descending": bool((np.diff(costs[perms[1]]) <= 0).all()),
         "balanced3_max_over_mean": float(sums3.max() / sums3.mean()),
         "contiguous3_max_over_mean": float(contiguous3.max() / contiguous3.mean()),
         "launches": launches}
    log(f"  (c) balanced frame: {c}")
    require(all(c["bit_equal"].values()) and c["perm1_descending"],
            "the permuted frames must equal the frame without a permutation")
    require(all(launches[k] > 0 for k in BALANCED_PATH),
            f"mesh_env_balanced must launch {BALANCED_PATH}: {launches}")
    rec["balanced"] = c

    # (d) the distributed code at world size 1 over NCCL
    group = sharding.make_mesh(1, device=DEV, init_method=f"file://{tmp / 'nccl_store'}",
                               rank=0)
    try:
        sdata = sharding.shard_scene(data, group)
        accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
        _, b_sh = sharding.render_frame_sharded(group, sdata, cam, 0, 0, accum, config)
        accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
        _, b_bal = balance.render_frame_balanced(group, sdata, cam, 0, 0, accum, config,
                                                 perms[3])
        samples = sharding.render_samples_sharded(group, sdata, cam, 0, config)
        single = render_sample(data, cam, 0, config)["radiance"]
        full = primary_planes(config, cam)
        t1, i1 = bt.bvh_closest(*full, *tabs, **kw)
        ro_flat, rd_flat = torch.stack(full[0:3]), torch.stack(full[3:6])
        ring = ring_sweep.build_ring_bvh(tris.packed, 1)
        t_rb, i_rb = ring_sweep.ring_closest_bvh(group, ro_flat, rd_flat, full[6], full[7],
                                                 ring)
        table, shard_rows = ring_sweep.shard_tris(tris.packed, 1)
        t_rs, i_rs = ring_sweep.ring_closest(group, ro_flat, rd_flat, full[6], full[7],
                                             table, shard_rows, inner="kernel")
    finally:
        dist.destroy_process_group()
    dd = {"sharded_bit_equal": frames_equal(b_sh, ref),
          "balanced_bit_equal": frames_equal(b_bal, ref),
          "samples_bit_equal": bool(torch.equal(samples, single)),
          "ring_bvh_t_bit_equal": bool(torch.equal(t_rb, t1)),
          "ring_bvh_rows": ties_only(full, tris.packed, t1, i_rb, i1),
          "ring_sweep_t_bit_equal": bool(torch.equal(t_rs, t1)),
          "ring_sweep_rows": ties_only(full, tris.packed, t1, i_rs, i1)}
    log(f"  (d) world size 1 over NCCL: {dd}")
    require(dd["sharded_bit_equal"] and dd["balanced_bit_equal"] and dd["samples_bit_equal"]
            and dd["ring_bvh_t_bit_equal"] and dd["ring_sweep_t_bit_equal"]
            and dd["ring_bvh_rows"]["rows_off"] == dd["ring_bvh_rows"]["ties"]
            and dd["ring_sweep_rows"]["rows_off"] == dd["ring_sweep_rows"]["ties"],
            "the distributed code at world size 1 must equal the single-device calls")
    rec["world1"] = dd
    del data, sdata, ref, got, b_sh, b_bal
    torch.cuda.empty_cache()

    rec["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 (a)-(d) took {rec['seconds']:.1f} s")
    results.setdefault("parallel", {}).update(rec)
    return launches


def phase_ring_rounds(big, results, reps: int = 1):
    """Phase 16 (e), run right after phase 10 while big_env's tables
    (``big``) are alive: the ring's rounds at D = 4 in one process on its
    405k rows and 1080p primary rays, both inners against K1 on the whole
    table; with ``reps`` > 1 each inner's rounds are timed ``reps`` - 1
    times more (``ms_all_rounds_reps``), and one sweep round of the first
    rank (``round_ms``, with what it builds each round), its K5 call alone
    (``kernel_ms``) and the build of one shard's boxes (``boxes_ms``)
    between CUDA events."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.accel import sweep as sw
    from pupiloptixlab_tpu_torch.parallel import ring_sweep

    t_phase = time.perf_counter()
    bdata, bconfig, bcam = big
    btris = bdata.tris
    full = primary_planes(bconfig, bcam)
    n = bconfig.width * bconfig.height
    btabs = bvh_tables(btris)
    t1, i1 = bt.bvh_closest(*full, *btabs, tcl=bconfig.bvh_tcl, depth=btris.bvh_depth)
    k1_ms = cuda_time_ms(lambda: bt.bvh_closest(*full, *btabs, tcl=bconfig.bvh_tcl,
                                                depth=btris.bvh_depth), reps=3)
    t0 = time.perf_counter()
    ring = ring_sweep.build_ring_bvh(btris.packed, RING_SHARDS)
    build_s = time.perf_counter() - t0
    table, shard_rows = ring_sweep.shard_tris(btris.packed, RING_SHARDS)
    per = n // RING_SHARDS

    def rounds(step):
        outs_t, outs_i = [], []
        for my in range(RING_SHARDS):
            sl = [p[my * per:(my + 1) * per] for p in full]
            best = (torch.full((per,), 1e16, device=DEV),
                    torch.full((per,), -1, dtype=torch.int32, device=DEV))
            for k in range(RING_SHARDS):
                best = step(best, sl, (my + k) % RING_SHARDS)
            outs_t.append(best[0])
            outs_i.append(best[1])
        return torch.cat(outs_t), torch.cat(outs_i)

    def bvh_step(best, sl, s):
        return ring_sweep.bvh_round(*best, sl, ring.shard_tables(s), s, ring)

    def shard(s):
        return table[s * shard_rows:(s + 1) * shard_rows]

    sl0 = [p[:per] for p in full]
    best0 = (torch.full((per,), 1e16, device=DEV),
             torch.full((per,), -1, dtype=torch.int32, device=DEV))
    if hasattr(ring_sweep, "sweep_shard"):  # each rank builds its own shard's boxes once
        def sweep_rounds():
            held = [ring_sweep.sweep_shard(shard(s), "kernel") for s in range(RING_SHARDS)]
            return rounds(lambda best, sl, s: ring_sweep.sweep_round(
                *best, sl, held[s], s * shard_rows, shard_rows, inner="kernel"))
        held0 = ring_sweep.sweep_shard(shard(0), "kernel")

        def one_round():
            return ring_sweep.sweep_round(*best0, sl0, held0, 0, shard_rows, inner="kernel")

        def k5_alone():
            return sw.sweep_closest(*sl0, *held0, rows=shard_rows)

        def boxes():
            return ring_sweep.sweep_shard(shard(0), "kernel")
    else:  # an earlier package (--sweep --package) builds them every round
        def sweep_rounds():
            return rounds(lambda best, sl, s: ring_sweep.sweep_round(
                *best, sl, shard(s), s * shard_rows, inner="kernel"))
        rows0 = torch.cat([shard(0), shard(0).new_zeros(((-shard_rows) % sw.CHUNK, 12))])
        boxes0 = ring_sweep._chunk_boxes(rows0, sw.CHUNK)
        sboxes0 = sw.super_boxes(boxes0)

        def one_round():
            return ring_sweep.sweep_round(*best0, sl0, shard(0), 0, inner="kernel")

        def k5_alone():
            return sw.sweep_closest(*sl0, rows0, boxes0, sboxes0)

        def boxes():
            return sw.super_boxes(ring_sweep._chunk_boxes(rows0, sw.CHUNK))

    e = {"shards": RING_SHARDS, "shard_rows": ring.shard_rows, "tcl": ring.tcl,
         "depths": list(ring.depth), "build_s": build_s, "k1_ms": k1_ms}
    hits = int((i1 >= 0).sum())
    for name, run in (("bvh", lambda: rounds(bvh_step)), ("sweep", sweep_rounds)):
        (t_r, i_r), r_ms = host_timed(run)
        rows = ties_only(full, btris.packed, t1, i_r, i1)
        e[name] = {"ms_all_rounds": r_ms, "t_bit_equal": bool(torch.equal(t_r, t1)),
                   "hits": hits, **rows}
        if reps > 1:
            e[name]["ms_all_rounds_reps"] = [host_timed(run)[1] for _ in range(reps - 1)]
    if reps > 1:
        e["sweep"]["round_ms"] = cuda_time_ms(one_round, reps=5)
        e["sweep"]["kernel_ms"] = cuda_time_ms(k5_alone, reps=5)
        e["sweep"]["boxes_ms"] = cuda_time_ms(boxes, reps=5)
    log(f"  (e) ring rounds at D={RING_SHARDS} on big_env ({btris.packed.shape[0]} rows), "
        f"N={n}: {e}")
    for name in ("bvh", "sweep"):
        r = e[name]
        require(r["t_bit_equal"] and r["rows_off"] == r["ties"] and r["ties"] <= 1e-4 * hits,
                f"ring rounds ({name}): t must equal K1's, rows off only on ties (<= 1e-4)")
    e["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 16 (e) took {e['seconds']:.1f} s")
    results.setdefault("parallel", {})["ring_d4"] = e


# -- the slice of spectral transport, the sanitizer, ReSTIR and the wavefront
# engine: phases 17-21. Their launches are checked in each phase (every
# kernel of the path must launch, none of the other route's) and stay out of
# the kernels line, whose sums cover the paths of PATHS_OF.

DISPERSION = DATA / "dispersion.xml"
SWEEP_KERNELS = ("sweep_closest", "sweep_anyhit", "gather_planes", "count_less")
BVH_KERNELS = ("bvh_closest", "bvh_anyhit", "gather_planes", "count_less")
PARITY_SEEDS = (0, 1)


def lit_mesh_env(width: int, height: int):
    """data/mesh_env.xml plus one area-lit rectangle above its floor, built
    through the port's scene layer: an envmap alone gives ReSTIR no area
    light, so its reservoirs would never run on the BVH route."""
    from pupiloptixlab_tpu_torch.scene import load_scene
    from pupiloptixlab_tpu_torch.scene.emitters import Emitter, EmitterType
    from pupiloptixlab_tpu_torch.scene.materials import Material, MatType
    from pupiloptixlab_tpu_torch.scene.shapes import ShapeInstance
    from pupiloptixlab_tpu_torch.scene.textures import rgb_texture
    from pupiloptixlab_tpu_torch.utils.math import Transform

    scene = load_scene(MESH_ENV)
    scene.sensor.film.w, scene.sensor.film.h = width, height
    scene.shape_instances.append(ShapeInstance(
        shape=scene.shape_manager.load_rectangle(),
        material=Material(type=MatType.DIFFUSE),
        transform=Transform().scale(0.8, 0.8, 1).rotate(1, 0, 0, 90).translate(0.0, 3.0, 0.0),
        emitter=Emitter(type=EmitterType.AREA, radiance=rgb_texture(8.0, 8.0, 8.0)),
        is_emitter=True,
    ))
    return scene


def set_scene_object(system, scene) -> None:
    """System.set_scene for a Scene built in code: the world takes it and
    the passes get SCENE_LOAD, as after a file load."""
    from pupiloptixlab_tpu_torch.utils.event import SCENE_LOAD

    system.world.set_scene(scene)
    system.events.dispatch(SCENE_LOAD, system.world)


def moved_camera(scene, dx: float, device):
    """The scene's camera block with the camera trucked ``dx`` along its
    right axis (the scene is left as it was)."""
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene
    from pupiloptixlab_tpu_torch.utils.math import Transform

    old = scene.sensor.transform
    m = old.matrix.copy()
    m[:3, 3] += m[:3, 0] * dx
    scene.sensor.transform = Transform(m)
    try:
        return camera_block_from_scene(scene, device=device)
    finally:
        scene.sensor.transform = old


NEW_WARM, NEW_FRAMES = 2, 4  # warm-up frames, all frames, of each System run of phases 17-19


def drive_system(label, make_pass, load, buffer, results, path, absent=(), before=None,
                 check=None):
    """A pass through System on the card as a user drives it: ``load(system)``
    sets the scene, then NEW_WARM warm-up frames and the rest of NEW_FRAMES
    timed (``before(i, system)`` ahead of frame i), the launch counts set to
    0 just before the first frame and read just after the last; every kernel
    of ``path`` must launch, none of ``absent``. Returns the pass."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.system import System

    system = System()
    p = make_pass()
    system.add_pass(p)
    t0 = time.perf_counter()
    load(system)
    load_s = time.perf_counter() - t0
    if check is not None:
        check(p)
    n = p._config.width * p._config.height
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    frames = NEW_FRAMES
    for i in range(frames):
        if before is not None:
            before(i, system)
        t0 = time.perf_counter()
        system.run(max_frames=1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    frame = system.buffers[buffer].array
    finite = bool(torch.isfinite(frame).all())
    mean = float(frame.mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sum(times[NEW_WARM:]) / (frames - NEW_WARM)
    per_frame = {k: v / frames for k, v in launches.items() if v}
    log(f"  {label} {p._config.width}x{p._config.height} depth {p._config.max_depth}: "
        f"set_scene {load_s:.2f} s, warm-up {', '.join(f'{t:.1f}' for t in times[:NEW_WARM])} "
        f"ms, {ms:.2f} ms/frame (frames {', '.join(f'{t:.1f}' for t in times[NEW_WARM:])}), "
        f"mean {mean:.5f}, peak "
        f"{peak_gb:.2f} GB, launches a frame {per_frame}")
    require(tuple(frame.shape) == (n, 3) and finite and mean > 0.0,
            f"{label}: frame is not finite and non-zero")
    require(all(launches[k] > 0 for k in path) and all(launches[k] == 0 for k in absent),
            f"{label}: the path must launch {path} and not {absent}: {launches}")
    results.setdefault("new_paths", {})[label] = {
        "ms_per_frame": ms, "frame_ms": times, "set_scene_s": load_s, "mean": mean,
        "peak_gb": peak_gb, "frames": frames, "launches": launches,
        "launches_per_frame": per_frame}
    system.destroy()
    return p


def phase_spectral(tmp, results) -> None:
    """Hero-wavelength transport at 1920x1080 through System + PTPass:
    dispersion.xml (its own spectral integrator, depth 6, the chunk sweep)
    and mesh_env under PTPass(spectral=True) (depth 4, K1/K2)."""
    from pupiloptixlab_tpu_torch.passes import PTPass

    def expect(route_bvh, depth):
        def check(p):
            c = p._config
            require(c.spectral and (c.bvh_nodes > 0) == route_bvh
                    and (c.width, c.height, c.max_depth) == (*FILM, depth),
                    f"expected a spectral frame at 1920x1080 depth {depth}: {c}")
        return check

    drive_system("spectral dispersion", PTPass,
                 lambda s: require(s.set_scene(scene_copy(DISPERSION, *FILM, tmp)), "set_scene"),
                 "pt accum", results, SWEEP_KERNELS, ("bvh_closest", "bvh_anyhit"),
                 check=expect(False, 6))
    drive_system("spectral mesh_env", lambda: PTPass(spectral=True),
                 lambda s: require(s.set_scene(scene_copy(MESH_ENV, *FILM, tmp)), "set_scene"),
                 "pt accum", results, BVH_KERNELS, ("sweep_closest", "sweep_anyhit"),
                 check=expect(True, 4))


def phase_sanitizer(results) -> None:
    """The value sanitizer on a mesh_env frame at 1920x1080 (render_frame
    with debug_checks): the report all zeros; then NaN constant colours in
    a copy of the texture table (the reference's tests/test_sanitizer.py:58):
    assert_all_finite raises SanitizerError naming the radiance stage."""
    import dataclasses

    import torch

    from pupiloptixlab_tpu_torch.flatten.types import TEX_RGB
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.utils.debug import SanitizerError, assert_all_finite

    data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
    config = dataclasses.replace(config, debug_checks=True)
    n = config.width * config.height
    accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
    render_frame(data, cam, 0, 0, accum, config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, bufs = render_frame(data, cam, 1, 1, accum, config)
    assert_all_finite(bufs["sanitizer"], context="mesh_env")
    ms = (time.perf_counter() - t0) * 1e3
    clean = {k: int(v) for k, v in bufs["sanitizer"].items()}
    log(f"  mesh_env {config.width}x{config.height} with debug_checks: report {clean}, {ms:.1f} ms for the frame "
        f"and its gate")
    require(set(clean) == {"radiance", "albedo", "normal", "primary_t", "throughput"}
            and not any(clean.values()), f"sanitizer: a clean frame reported {clean}")
    tex = data.textures.packed.clone()
    tex[:, TEX_RGB] = float("nan")
    bad = dataclasses.replace(data, textures=dataclasses.replace(data.textures, packed=tex))
    _, bufs = render_frame(bad, cam, 2, 0, accum, config)
    report = {k: int(v) for k, v in bufs["sanitizer"].items()}
    try:
        assert_all_finite(bufs["sanitizer"], context="mesh_env")
        raised = None
    except SanitizerError as exc:
        raised = str(exc)
    log(f"  NaN texture colours: report {report}; raised: {raised}")
    require(raised is not None and "radiance" in raised and report["radiance"] > 0,
            "sanitizer: NaN texture colours did not raise SanitizerError naming radiance")
    results["sanitizer"] = {"clean": clean, "nan_textures": report, "error": raised,
                            "frame_and_gate_ms": ms}


def phase_restir(tmp, results) -> None:
    """ReSTIRPass at 1920x1080 through System: DI and GI on oracle_mat (the
    chunk sweep) and on mesh_env with one added area light (K1/K2). From
    the second frame on the temporal merge has history; GI's camera moves
    before its last frame, which keeps the reservoirs through the motion
    warp (DI's history resets on a camera edit, so DI's camera stays)."""
    from pupiloptixlab_tpu_torch.passes import ReSTIRPass
    from pupiloptixlab_tpu_torch.utils.event import CAMERA_MOVE

    def move(i, system):
        if i == NEW_FRAMES - 1:
            system.events.dispatch(CAMERA_MOVE, (3.0, 0.0, 0.0))

    def check_history(p):
        m = p._reservoirs[:, 11]
        require(float(m.max()) > 0.0, "restir: no reservoir took a sample")

    def load_oracle(system):
        require(system.set_scene(scene_copy(ORACLE_MAT, *FILM, tmp)), "set_scene")

    def load_lit(system):
        set_scene_object(system, lit_mesh_env(*FILM))
        require(system.world.get_scene_data()[1].emitter_count > 0, "no area light")

    for name, gi in (("DI", False), ("GI", True)):
        for scene, load, path, absent in (
                ("oracle_mat", load_oracle, SWEEP_KERNELS, ("bvh_closest", "bvh_anyhit")),
                ("lit mesh_env", load_lit, BVH_KERNELS, ("sweep_closest", "sweep_anyhit"))):
            p = drive_system(f"ReSTIR {name} {scene}", lambda: ReSTIRPass(gi=gi), load,
                             "restir accum", results, path, absent,
                             before=move if gi else None)
            check_history(p)
            m = float(p._reservoirs[:, 11].max())
            log(f"    reservoirs: largest M {m:.0f}")
            results["new_paths"][f"ReSTIR {name} {scene}"]["max_m"] = m


def phase_wavefront(results) -> None:
    """render_wavefront at 1920x1080, spp 1, on mesh_env (K1/K2) and
    oracle_mat (the chunk sweep): 1 warm-up + 2 timed calls, the counts set
    to 0 just before and read just after; its iterations and host syncs."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.wavefront import render_wavefront

    for label, xml, path, absent in (
            ("wavefront mesh_env", MESH_ENV, BVH_KERNELS, ("sweep_closest", "sweep_anyhit")),
            ("wavefront oracle_mat", ORACLE_MAT, SWEEP_KERNELS, ("bvh_closest", "bvh_anyhit"))):
        data, config, cam = load_tables(xml, *FILM, DEV)
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for seed in range(3):
            t0 = time.perf_counter()
            out = render_wavefront(data, cam, seed, config, spp=1)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(kernels.LAUNCHES)
        film = out["film"]
        mean = float(film.mean())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_frame = {k: v / 3 for k, v in launches.items() if v}
        ms = (times[1] + times[2]) / 2
        log(f"  {label} {config.width}x{config.height} spp 1 depth {config.max_depth}: warm-up "
            f"{times[0]:.1f} ms, {ms:.2f} ms/frame (frames {times[1]:.1f}, {times[2]:.1f}), "
            f"{out['iterations']} iterations, {out['syncs']} host "
            f"syncs, mean {mean:.5f}, peak {peak_gb:.2f} GB, launches a frame {per_frame}")
        require(bool(torch.isfinite(film).all()) and mean > 0.0, f"{label}: film not finite")
        require(out["syncs"] == out["iterations"] + 1, f"{label}: one sync an iteration")
        require(all(launches[k] > 0 for k in path) and all(launches[k] == 0 for k in absent),
                f"{label}: the path must launch {path} and not {absent}: {launches}")
        results.setdefault("new_paths", {})[label] = {
            "ms_per_frame": ms, "frame_ms": times, "iterations": out["iterations"],
            "syncs": out["syncs"], "mean": mean, "peak_gb": peak_gb, "launches": launches,
            "launches_per_frame": per_frame}
        del data, out, film
        torch.cuda.empty_cache()


def image_gate(label, card, cpu, worst) -> None:
    """Phase 7's image limits on one (card, CPU) pair of (N, 3) arrays."""
    import numpy as np

    rel = float(np.mean((card - cpu) ** 2) / max(np.mean(cpu ** 2), 1e-30))
    frac = float(np.isclose(card, cpu, rtol=1e-4, atol=0.0).all(-1).mean())
    log(f"  {label}: rel MSE {rel:.3e}, pixels within rtol 1e-4 {frac:.4f}")
    require(np.isfinite(card).all() and rel <= 1e-5 and frac >= 0.99,
            f"card and CPU frames disagree: {label}")
    worst["rel_mse"] = max(worst.get("rel_mse", 0.0), rel)
    worst["frac_within_1e-4"] = min(worst.get("frac_within_1e-4", 1.0), frac)


def phase_new_parity(results) -> None:
    """Every path of phases 17-21 on the card against the CPU at equal
    seeds on small films: spectral dispersion.xml 64x64 and mesh_env 128x8
    (2 progressive frames; test AOV bit-equal, the sanitizer's report equal
    on the latter); ReSTIR DI and GI, 2 frames each, on oracle_mat 64x64 and
    the lit mesh_env 128x8 (GI's second frame after a camera move, with
    prev_camera; frames and accumulation held, the packed reservoirs
    reported); the wavefront frame (spp 1) on mesh_env 128x8 and oracle_mat
    64x64, whose film scatter adds a pixel's lanes in the same order on
    both devices. Limits: rel MSE <= 1e-5, >= 99% of pixels within rtol
    1e-4."""
    import dataclasses

    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.render.restir import N_PACK, restir_frame
    from pupiloptixlab_tpu_torch.render.restir_gi import restir_gi_frame
    from pupiloptixlab_tpu_torch.wavefront import render_wavefront

    worst = {}
    packed_near = []

    def tables(scene, dev):
        data, config = flatten_scene(scene, device=dev)
        return data, config, camera_block_from_scene(scene, device=dev)

    def scene_at(xml, w, h):
        from pupiloptixlab_tpu_torch.scene import load_scene

        scene = load_scene(xml)
        scene.sensor.film.w, scene.sensor.film.h = w, h
        return scene

    # spectral
    for label, scene, spectral in (("dispersion 64x64", scene_at(DISPERSION, 64, 64), None),
                                   ("mesh_env 128x8", scene_at(MESH_ENV, 128, 8), True)):
        seqs = []
        for dev in (DEV, "cpu"):
            data, config, cam = tables(scene, dev)
            config = dataclasses.replace(config, spectral=True, debug_checks=True)
            accum = torch.zeros((config.width * config.height, 3), device=dev)
            seq = []
            for i in PARITY_SEEDS:
                _, b = render_frame(data, cam, i, i, accum, config)
                seq.append({k: (v.cpu().numpy().copy() if k != "sanitizer" else
                                {s: int(c) for s, c in v.items()}) for k, v in b.items()})
            seqs.append(seq)
        for i, (g, c) in enumerate(zip(*seqs)):
            image_gate(f"spectral {label} seed {i}", g["frame"], c["frame"], worst)
            require(np.array_equal(g["test"], c["test"]) and g["sanitizer"] == c["sanitizer"],
                    f"spectral {label}: test AOV or sanitizer report differ")
        log(f"    sanitizer report (card = CPU): {seqs[0][-1]['sanitizer']}")

    # ReSTIR DI and GI
    for label, scene in (("oracle_mat 64x64", scene_at(ORACLE_MAT, 64, 64)),
                         ("lit mesh_env 128x8", lit_mesh_env(128, 8))):
        for name, gi in (("DI", False), ("GI", True)):
            outs = []
            for dev in (DEV, "cpu"):
                data, config, cam = tables(scene, dev)
                cam1 = moved_camera(scene, 0.15, dev)
                n = config.width * config.height
                acc = torch.zeros((n, 3), device=dev)
                packed = torch.zeros((n, N_PACK), device=dev)
                seq = []
                for i in PARITY_SEEDS:
                    if gi:
                        acc, packed, frame = restir_gi_frame(
                            data, cam1 if i else cam, i, packed, acc, i, config,
                            prev_camera=cam if i else None)
                    else:
                        acc, packed, frame = restir_frame(data, cam, i, packed, acc, i, config)
                    seq.append([x.cpu().numpy().copy() for x in (frame, acc, packed)])
                outs.append(seq)
            for i, (g, c) in enumerate(zip(*outs)):
                image_gate(f"ReSTIR {name} {label} frame {i}", g[0], c[0], worst)
                image_gate(f"ReSTIR {name} {label} accum {i}", g[1], c[1], worst)
                near = float(np.isclose(g[2], c[2], rtol=1e-4, atol=1e-5).mean())
                packed_near.append(near)
                log(f"    packed reservoirs within rtol 1e-4 + atol 1e-5: {near:.6f}")

    # wavefront
    for label, scene in (("mesh_env 128x8", scene_at(MESH_ENV, 128, 8)),
                         ("oracle_mat 64x64", scene_at(ORACLE_MAT, 64, 64))):
        films = []
        for dev in (DEV, "cpu"):
            data, config, cam = tables(scene, dev)
            films.append(render_wavefront(data, cam, 5, config, spp=1)["film"].cpu().numpy())
        image_gate(f"wavefront {label}", films[0], films[1], worst)
    results["parity_new_paths"] = {**worst, "packed_near_min": min(packed_near)}


DISPLAY_FRAMES = 4      # timed frames of each kind in phase 22 (after one warm-up)
COMPUTE_SIZE, COMPUTE_FRAMES = 256, 10  # phase 22(d): compute_test_torch's animate


def http(port: int, path: str, body=None, timeout: float = 60.0):
    """(payload, content type) of a GET, or of a POST of ``body`` as JSON,
    to the web client on this machine."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type", "")


def post(port: int, route: str, body: dict) -> dict:
    return json.loads(http(port, f"/api/{route}", body)[0])


def wait_for(cond, timeout: float, what: str) -> None:
    t0 = time.monotonic()
    while not cond():
        require(time.monotonic() - t0 < timeout, f"waited {timeout:.0f} s for {what}")
        time.sleep(0.005)


def frame_ms(system, n: int) -> list:
    """Host ms of n + 1 single frames through System.run, each ended by a
    synchronise; the first is a warm-up."""
    import torch

    out = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.run(max_frames=1)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out[1:]


def mean(xs) -> float:
    return sum(xs) / len(xs)


def package_imports(name: str) -> bool:
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def phase_display(tmp, results) -> None:
    """Phase 22: the display clients, checkpoints, profiling and the compute
    pass on the card. (a) System(display="web", web_port=0) + PTPass on
    mesh_env at 1920x1080, depth 4, its render thread running
    (System.run(threaded=True)), driven over HTTP; (b) a checkpoint of a
    headless System's PTPass resumed bit-equal; (c) FrameStats and a trace
    of that System; (d) ComputePass card against CPU."""
    import threading

    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.display.tonemap import expand_to_rgba
    from pupiloptixlab_tpu_torch.display.web import _encode_jpeg, _encode_png
    from pupiloptixlab_tpu_torch.passes import ComputePass, PTPass
    from pupiloptixlab_tpu_torch.system import System
    from pupiloptixlab_tpu_torch.utils.checkpoint import (
        TREE_FILE,
        restore_render_state,
        save_render_state,
    )
    from pupiloptixlab_tpu_torch.utils.event import FRAME_FINISHED
    from pupiloptixlab_tpu_torch.utils.image import read_exr
    from pupiloptixlab_tpu_torch.utils.profiling import FrameStats, annotate, trace
    from pupiloptixlab_tpu_torch.world import world as world_mod

    out = {"pillow": package_imports("PIL"), "matplotlib": package_imports("matplotlib")}
    log(f"  Pillow imports: {out['pillow']}; matplotlib imports: {out['matplotlib']}")
    xml = scene_copy(MESH_ENV, *FILM, tmp)

    # (a) the web client on the card, its render thread running
    system = System(display="web", web_port=0)
    pt = PTPass()
    system.add_pass(pt)
    t0 = time.perf_counter()
    require(system.set_scene(xml), "set_scene")
    out["set_scene_s"] = time.perf_counter() - t0
    c = pt._config
    require((c.width, c.height, c.max_depth) == (*FILM, 4) and c.bvh_nodes > 0,
            f"expected mesh_env's BVH route at 1920x1080 depth 4: {c}")
    d = system.display
    frames = []
    system.events.bind(FRAME_FINISHED, frames.append)
    flattens = []
    real = world_mod.flatten_scene

    def counting(*args, **kwargs):
        flattens.append(1)
        return real(*args, **kwargs)

    world_mod.flatten_scene = counting
    d.start()
    port = d.port
    torch.cuda.synchronize()
    kernels.reset_launches()
    runner = threading.Thread(target=system.run, kwargs={"threaded": True}, daemon=True)
    runner.start()
    try:
        wait_for(lambda: d.latest_image() is not None, 120, "a first displayed frame")
        state = json.loads(http(port, "/api/state")[0])
        require(state["rendering"] and "pt frame" in state["buffers"]
                and [p["name"] for p in state["passes"]] == ["Path Tracing"]
                and {o["name"] for o in state["objects"]} == {"Ball", "Floor"},
                f"/api/state: {state}")
        t0 = time.perf_counter()
        png, ctype = http(port, "/frame.png")
        png_get_ms = (time.perf_counter() - t0) * 1e3
        ihdr = struct.unpack(">II", png[16:24])
        require(ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n" and png[12:16] == b"IHDR"
                and ihdr == FILM, f"/frame.png: {ctype}, IHDR {ihdr}")
        name, t = d.pick_object(0.5, 0.5)  # host numpy, as the route computes it
        r = post(port, "pick", {"x": 0.5, "y": 0.5})
        require(name is not None and r == {"ok": True, "name": name, "t": round(float(t), 4)},
                f"/api/pick at the centre: {r}, on the CPU {name} {t}")
        data0 = pt._scene_data
        n = len(frames)
        before = dict(kernels.LAUNCHES)
        require(post(port, "objdrag", {"name": name, "dx": 0.05, "dy": 0.0,
                                       "mode": "translate"})["ok"], "/api/objdrag")
        wait_for(lambda: len(frames) >= n + 3, 60, "frames after the object drag")
        after = dict(kernels.LAUNCHES)
        data1 = pt._scene_data
        refit = (data1 is not data0 and not flattens
                 and type(system.world._refit).__name__ == "RefitData"
                 and data1.tris.packed.shape == data0.tris.packed.shape
                 and not torch.equal(data1.tris.packed, data0.tris.packed))
        require(refit and all(after[k] > before[k] for k in ("bvh_closest", "bvh_anyhit")),
                f"the frames after /api/objdrag must run K1/K2 on refitted tables "
                f"(flattens {len(flattens)}, launches {before} -> {after})")
        wait_for(lambda: pt.sample_cnt >= 3, 60, "3 accumulated frames")
        cnt = pt.sample_cnt
        require(post(port, "input", {"type": "drag", "dx": 20, "dy": 0})["ok"], "/api/input")
        wait_for(lambda: pt.sample_cnt < cnt, 60, "the accumulation to restart after a drag")
        require(post(port, "render", {"action": "stop"})["ok"], "/api/render stop")

        def settled():
            m = len(frames)
            time.sleep(0.3)
            return len(frames) == m

        wait_for(settled, 30, "the render loop to stop")
        shot = tmp / "shot.exr"
        t0 = time.perf_counter()
        r = post(port, "screenshot", {"path": str(shot)})
        shot_ms = (time.perf_counter() - t0) * 1e3
        buf = system.buffers["pt frame"]
        want = expand_to_rgba(buf.array, *FILM).flip(0).cpu().numpy()
        require(r["ok"] and np.array_equal(read_exr(shot), want),
                "/api/screenshot: the EXR must equal the selected buffer, flipped")
        require(post(port, "render", {"action": "start"})["ok"], "/api/render start")
        stream = None
        if out["pillow"]:
            import urllib.request

            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stream", timeout=60) as resp:
                stream = resp.read(65536)
            require(b"--frame" in stream and b"image/jpeg" in stream and b"\xff\xd8" in stream,
                    "/stream: no JPEG part")
    finally:
        system.quit()
        runner.join(timeout=60)
        world_mod.flatten_scene = real
    system._render_thread.join(timeout=60)
    require(not runner.is_alive() and not system._render_thread.is_alive(),
            "quit must end the render thread and the client")
    launches = dict(kernels.LAUNCHES)
    require(all(launches[k] > 0 for k in BVH_KERNELS)
            and all(launches[k] == 0 for k in ("sweep_closest", "sweep_anyhit")),
            f"web client: the path must launch {BVH_KERNELS} and not K5/K6: {launches}")
    log(f"  web client on mesh_env {FILM[0]}x{FILM[1]}: set_scene {out['set_scene_s']:.2f} s, {len(frames)} "
        f"frames served, GET /frame.png {png_get_ms:.1f} ms ({len(png)} B), pick {name} at "
        f"t {t:.4f} (route = CPU), objdrag: refit without a flatten, K1/K2 after it, the "
        f"drag restarted the accumulation, screenshot EXR {shot_ms:.1f} ms = the buffer flipped, "
        f"/stream {'first part read' if stream else 'not read (no Pillow)'}; launches {launches}")
    out.update(frames_served=len(frames), png_get_ms=png_get_ms, png_bytes=len(png), pick=name,
               screenshot_exr_ms=shot_ms, stream_read=stream is not None, launches=launches)

    # (b) and the frame times: a headless System on the same scene
    hs = System()
    hp = PTPass()
    hs.add_pass(hp)
    require(hs.set_scene(xml), "set_scene")
    torch.cuda.synchronize()
    kernels.reset_launches()
    times = {"plain": frame_ms(hs, DISPLAY_FRAMES), "client": frame_ms(system, DISPLAY_FRAMES)}
    d._preview_until = float("inf")
    times["client_preview"] = frame_ms(system, DISPLAY_FRAMES)
    d._preview_until = 0.0
    times["plain_again"] = frame_ms(hs, DISPLAY_FRAMES)

    def pump_ms(stride_preview: bool) -> float:
        d._preview_until = float("inf") if stride_preview else 0.0
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d._on_frame_finished(0.0)  # to_display_u8 on the card, one uint8 fetch
            ms.append((time.perf_counter() - t0) * 1e3)
        d._preview_until = 0.0
        return mean(ms[1:])

    pump = {"preview": pump_ms(True), "full": pump_ms(False)}  # the full image last
    img = d.latest_image()
    require(img.shape == (FILM[1], FILM[0], 3) and img.dtype == np.uint8, f"image {img.shape}")
    encode = {}
    for label, fn in (("png", _encode_png), ("jpeg", _encode_jpeg if out["pillow"] else None)):
        if fn is not None:
            t0 = time.perf_counter()
            blob = fn(img)
            encode[label] = {"ms": (time.perf_counter() - t0) * 1e3, "bytes": len(blob)}
    ms = {k: mean(v) for k, v in times.items()}
    log(f"  {FILM[0]}x{FILM[1]} frame (host ms, mean of {DISPLAY_FRAMES} after a warm-up), headless "
        f"{ms['plain']:.2f} / {ms['plain_again']:.2f}, with the client bound {ms['client']:.2f}, "
        f"at the preview's stride 2 {ms['client_preview']:.2f}; the pump alone "
        f"(to_display_u8 + one uint8 fetch of {img.nbytes} B) {pump['full']:.2f} ms, at stride 2 "
        f"{pump['preview']:.2f}; encode {encode}")
    out.update(frame_ms=times, frame_ms_mean=ms, pump_ms=pump, encode=encode)
    system.display.shutdown()
    del system, d
    hp._set_scene(hs.world)
    hp.seed = 0
    hs.run(max_frames=6)
    ref = hp._accum.clone()
    hp._set_scene(hs.world)
    hp.seed = 0
    hs.run(max_frames=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_render_state(tmp / "ckpt", hp)
    save_ms = (time.perf_counter() - t0) * 1e3
    size = (tmp / "ckpt" / TREE_FILE).stat().st_size
    hp._set_scene(hs.world)
    require(hp.sample_cnt == 0 and float(hp._accum.abs().sum()) == 0.0, "fresh state")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restore_render_state(tmp / "ckpt", hp)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    require(hs.buffers["pt accum"].array is hp._accum and hp._accum.device.type == DEV
            and (hp.sample_cnt, hp.seed) == (3, 3), "restore: state and buffers")
    hs.run(max_frames=3)
    equal = torch.equal(hp._accum, ref)
    log(f"  checkpoint: save {save_ms:.1f} ms, restore {restore_ms:.1f} ms, {size} B "
        f"({hp._accum.numel() * 4} B of accum); 3 + restore + 3 frames bit-equal to 6 "
        f"uninterrupted: {equal}")
    require(equal and (hp.sample_cnt, hp.seed) == (6, 6), "checkpoint resume is not bit-equal")
    out["checkpoint"] = {"save_ms": save_ms, "restore_ms": restore_ms, "bytes": size,
                         "bit_equal": equal}

    # (c) FrameStats on that System, then a trace of 2 frames
    stats = FrameStats()
    stats.bind(hs)
    hs.run(max_frames=4)
    summary = stats.summary()
    require(summary["frames"] == 4 and "Path Tracing" in summary["passes"], f"{summary}")
    t0 = time.perf_counter()
    with trace(tmp / "trace") as logdir:
        for _ in range(2):
            with annotate("frame"):
                hs.run(max_frames=1)
    traced_ms = (time.perf_counter() - t0) * 1e3
    (path,) = Path(logdir).glob("pupil_*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    k1 = [e for e in events if "bvh_closest_kernel" in e.get("name", "")]
    # the host's ranges (the card's timeline mirrors each as gpu_user_annotation)
    marks = [e for e in events if e.get("name") == "frame" and e.get("cat") == "user_annotation"]
    log(f"  FrameStats over 4 frames {summary}; trace of 2 frames: {traced_ms:.1f} ms with the "
        f"profiler, {path.stat().st_size} B, {len(events)} events, K1 kernels {len(k1)}, "
        f"'frame' ranges {len(marks)}")
    require(len(k1) >= 8 and len(marks) == 2,
            "the trace must hold K1's kernel (4 a frame) and the 2 annotations")
    launches = dict(kernels.LAUNCHES)
    require(all(launches[k] > 0 for k in BVH_KERNELS)
            and all(launches[k] == 0 for k in ("sweep_closest", "sweep_anyhit")),
            f"headless mesh_env: the path must launch {BVH_KERNELS} and not K5/K6: {launches}")
    out["frame_stats"] = summary
    out["trace"] = {"bytes": path.stat().st_size, "events": len(events), "k1_kernels": len(k1),
                    "annotations": len(marks), "ms_two_frames": traced_ms}
    hs.destroy()
    del hs, hp, ref
    torch.cuda.empty_cache()

    # (d) ComputePass with compute_test_torch's animate, card against CPU
    spec = importlib.util.spec_from_file_location(
        "compute_test_torch", REPO / "examples" / "compute_test_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    bufs = []
    for dev in (None, "cpu"):
        cs = System(device=dev)
        cs.add_pass(ComputePass(lambda f, w, h, cs=cs: example.animate(f, w, h, cs.device),
                                COMPUTE_SIZE, COMPUTE_SIZE))
        cs.run(max_frames=COMPUTE_FRAMES)
        bufs.append({k: cs.buffers[k].array for k in cs.buffers.displayable_names()})
    card, cpu = bufs
    require(card.keys() == cpu.keys() == {"wave rgb", "wave x", "wave xy"}
            and all(v.device.type == DEV for v in card.values()), "ComputePass buffers")
    worst = max(float((card[k].cpu() - cpu[k]).abs().max()) for k in card)
    close = all(torch.allclose(card[k].cpu(), cpu[k], rtol=1e-6, atol=1e-6) for k in card)
    log(f"  ComputePass {COMPUTE_SIZE}x{COMPUTE_SIZE}, {COMPUTE_FRAMES} frames: card against CPU "
        f"max abs {worst:.3e} (rtol 1e-6, atol 1e-6: {close})")
    require(close, "ComputePass: card and CPU buffers disagree")
    out["compute"] = {"max_abs_err": worst}
    results["display"] = out


BATCH_SPP = 8                            # spp of each batch-against-loop check of phase 23
BATCH_STARTS = ((0, 0), (2**32 - 3, 5))  # (seed0, sample_cnt): from scratch, and across 2^32
BATCH_TIMED_SPP = 16                     # spp of the timed batches and loops
BATCH_BUFFERS = ("frame", "albedo", "normal", "test")


def eager_samples(data, config, cam, seed0: int, cnt: int, spp: int):
    """The eager loop the batch stands for: render_frame at seeds (seed0 +
    i) mod 2^32 and counts cnt + i into a zero accum; the last sample's
    buffers (copies)."""
    import torch

    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    accum = torch.zeros((config.width * config.height, 3), dtype=torch.float32, device=DEV)
    for i in range(spp):
        _, bufs = render_frame(data, cam, (seed0 + i) & 0xFFFFFFFF, cnt + i, accum, config)
    return {k: bufs[k].clone() for k in BATCH_BUFFERS}


def check_batch_route(label, data, config, cam, path, absent, results) -> None:
    """render_frame_batch at BATCH_SPP from each of BATCH_STARTS against
    the eager loop of render_frame at the same seeds and counts: accum and
    the last sample's albedo, normal and test bit-equal; the counts set to
    0 just before the batch and read just after: one replay launches every
    kernel of ``path`` and none of ``absent``, and the batch launched the
    warm-up's and the replays' calls, no more."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.render.integrator import BATCH_STATS, render_frame_batch

    n = config.width * config.height
    rec = {"film": [config.width, config.height], "depth": config.max_depth,
           "spectral": config.spectral, "spp": BATCH_SPP, "starts": {}}
    for seed0, cnt in BATCH_STARTS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
        _, bufs = render_frame_batch(data, cam, seed0, cnt, accum, config, BATCH_SPP)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        per = dict(BATCH_STATS["launches_per_sample"])
        want = eager_samples(data, config, cam, seed0, cnt, BATCH_SPP)
        equal = {k: bool(torch.equal(bufs[k], want[k])) for k in BATCH_BUFFERS}
        diff = float((bufs["frame"] - want["frame"]).abs().max())
        log(f"  {label} {config.width}x{config.height} depth {config.max_depth} spp "
            f"{BATCH_SPP} from seed {seed0}, count {cnt}: {secs:.2f} s, capture "
            f"{BATCH_STATS['capture_ms']:.1f} ms, instantiate "
            f"{BATCH_STATS['instantiate_ms']:.1f} ms, {BATCH_STATS['nodes']} nodes; one "
            f"replay launches {per}; bit-equal to the loop {equal} (max |d frame| {diff:.3e})")
        require(all(per.get(k, 0) > 0 for k in path) and not any(per.get(k) for k in absent),
                f"{label}: a replay must launch {path} and not {absent}: {per}")
        require(launches == {k: v * (BATCH_SPP + 1) for k, v in per.items()},
                f"{label}: the batch launched {launches}, not the warm-up's and "
                f"{BATCH_SPP} replays' {per}")
        require(all(equal.values()), f"{label}: the batch is not bit-equal to the loop: {equal}")
        require(bool(torch.isfinite(bufs["frame"]).all()) and float(bufs["frame"].mean()) > 0.0,
                f"{label}: the batch's frame is not finite and non-zero")
        rec["starts"][f"{seed0},{cnt}"] = {"seconds": secs, "launches": launches,
                                           "equal": equal, "stats": dict(BATCH_STATS)}
    results.setdefault("batch", {})[label] = rec


def time_batch(label, data, config, cam, results) -> None:
    """Host ms a sample at BATCH_TIMED_SPP, ended by torch.cuda.synchronize():
    the eager loop and render_frame_batch in turns (loop, batch, batch,
    loop), each with its peak device memory; the batch's own warm-up,
    capture, instantiation and replay ms apart (BATCH_STATS)."""
    import torch

    from pupiloptixlab_tpu_torch.render.integrator import BATCH_STATS, render_frame_batch

    n = config.width * config.height
    spp = BATCH_TIMED_SPP
    runs = []
    for form in ("loop", "batch", "batch", "loop"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if form == "loop":
            eager_samples(data, config, cam, 0, 0, spp)
        else:
            accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
            render_frame_batch(data, cam, 0, 0, accum, config, spp)
        torch.cuda.synchronize()
        run = {"form": form, "ms_per_sample": (time.perf_counter() - t0) * 1e3 / spp,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if form == "batch":
            run.update({k: BATCH_STATS[k] for k in ("warmup_ms", "capture_ms",
                                                    "instantiate_ms", "replay_ms", "nodes")})
            run["replay_ms_per_sample"] = BATCH_STATS["replay_ms"] / spp
        runs.append(run)
    for r in runs:
        extra = (f"; warm-up {r['warmup_ms']:.1f}, capture {r['capture_ms']:.1f}, "
                 f"instantiate {r['instantiate_ms']:.1f}, replays {r['replay_ms']:.1f} ms "
                 f"({r['replay_ms_per_sample']:.2f} a sample), {r['nodes']} nodes"
                 if r["form"] == "batch" else "")
        log(f"  {label} spp {spp} {r['form']}: {r['ms_per_sample']:.2f} ms a sample, peak "
            f"{r['peak_gb']:.2f} GB{extra}")
    results.setdefault("batch_timing", {})[label] = runs


def fault_tables(data, config, cam):
    """A copy of the tables with the start of the leaf that most 1080p
    primary rays hit moved 16 rows off its leaf grid (leaf size 32: the
    sub-leaf order's 16-byte loads stay aligned, and K1 sets flag 4)."""
    import dataclasses

    import torch

    from pupiloptixlab_tpu_torch.accel.bvh_traverse import bvh_closest

    tris = data.tris
    tcl = config.bvh_tcl
    require(tcl == 32, f"the fault check wants leaves of 32 rows, got {tcl}")
    _, idx = bvh_closest(*primary_planes(config, cam), tris.packed, tris.bvh_child,
                         tris.bvh_axis, tris.bvh_boxes, tris.subleaf_rows,
                         tris.subleaf_boxes, tcl=tcl, depth=tris.bvh_depth)
    start = int(torch.mode(idx[idx >= 0] // tcl).values) * tcl
    require(start + 16 <= tris.packed.shape[0] - tcl, "the hit leaf is the table's last")
    child = tris.bvh_child.clone()
    at = child == -(start + 1)
    require(int(at.sum()) == 1, f"leaf {start} is not one child entry")
    child[at] = -(start + 16 + 1)
    return dataclasses.replace(data, tris=dataclasses.replace(tris, bvh_child=child)), start


def check_batch_fault(results) -> None:
    """A traversal fault still raises: mesh_env under PUPIL_TCL=32 at
    1920x1080 with one leaf start off the leaf grid (fault_tables): the
    batch must raise after its replays, naming bvh_closest; render_frame
    on the same tables must raise too; the intact tables raise nothing."""
    import torch

    from pupiloptixlab_tpu_torch.render.integrator import (
        BATCH_STATS,
        render_frame,
        render_frame_batch,
    )

    with pupil_env("PUPIL_TCL", "32"):
        data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
    bad, start = fault_tables(data, config, cam)
    n = config.width * config.height
    spp = 2
    render_frame_batch(data, cam, 0, 0, torch.zeros((n, 3), device=DEV), config, spp)
    rec = {"leaf_start": start}
    for form in ("batch", "render_frame"):
        BATCH_STATS.clear()
        accum = torch.zeros((n, 3), dtype=torch.float32, device=DEV)
        try:
            if form == "batch":
                render_frame_batch(bad, cam, 0, 0, accum, config, spp)
            else:
                render_frame(bad, cam, 0, 0, accum, config)
            msg = None
        except RuntimeError as e:
            msg = str(e)
        torch.cuda.synchronize()
        replays = BATCH_STATS.get("replays")
        log(f"  leaf {start} moved to {start + 16}, {form}: raised {msg!r}"
            + (f" after {replays} replays" if form == "batch" else ""))
        code = re.search(r"bvh_closest: traversal fault flag (\d+)", msg or "")
        require(code is not None and int(code.group(1)) & 4,
                f"{form}: a leaf start off the grid must raise naming bvh_closest, got {msg!r}")
        require(form != "batch" or replays == spp,
                f"the batch must raise after its {spp} replays, not before ({replays})")
        rec[form] = {"message": msg, "replays": replays}
    results.setdefault("batch", {})["fault"] = rec


def batch_routes(tmp):
    """The scenes of phase 23 at 1920x1080, one a route, loaded one at a
    time: (label, tables, the kernels a replay must launch, those it must
    not, the matmul-form switch)."""
    from pupiloptixlab_tpu_torch.scene.instanced_grid import write_instanced_scene

    bvh, sweep = BVH_KERNELS, SWEEP_KERNELS
    yield "mesh_env", lambda: load_tables(MESH_ENV, *FILM, DEV), bvh, sweep[:2], False
    yield "oracle_mat", lambda: load_tables(ORACLE_MAT, *FILM, DEV), sweep, bvh[:2], False
    yield ("mesh_env_nobvh", lambda: load_tables(MESH_ENV, *FILM, DEV, no_bvh=True), sweep,
           bvh[:2], False)

    def instanced():
        xml = write_instanced_scene(tmp / "batch_instanced", SKY, INST_N, INST_GRID, *FILM,
                                    max_depth=4)
        return load_tables(xml, *FILM, DEV)

    yield "instanced", instanced, INST_PATH, bvh[:2] + sweep[:2], False

    def mt32():
        with pupil_env("PUPIL_TCL", "32"):
            return load_tables(MESH_ENV, *FILM, DEV)

    yield "mesh_env_mt32", mt32, MT_PATH, ("bvh_closest",) + sweep[:2], True
    yield "spectral dispersion", lambda: load_tables(DISPERSION, *FILM, DEV), sweep, bvh[:2], False


def phase_batch(tmp, results) -> None:
    """Phase 23: render_frame_batch on every route at 1920x1080, depth 4
    (dispersion.xml its own 6) against the eager loop (check_batch_route),
    the host ms a sample of both forms on mesh_env and oracle_mat
    (time_batch), and a fault raised after the replays (check_batch_fault)."""
    import torch

    from pupiloptixlab_tpu_torch.accel.intersect import uses_mt

    for label, load, path, absent, mt in batch_routes(tmp):
        data, config, cam = load()
        with matmul_form(mt):
            require(uses_mt(data.tris, config) == mt, f"{label}: matmul-form route {not mt}")
            require(config.spectral == label.startswith("spectral"),
                    f"{label}: spectral {config.spectral}")
            check_batch_route(label, data, config, cam, path, absent, results)
            if label in ("mesh_env", "oracle_mat"):
                time_batch(label, data, config, cam, results)
        del data
        torch.cuda.empty_cache()
    check_batch_fault(results)
    torch.cuda.empty_cache()


def build(kernels) -> None:
    log("[build] nvcc, one process per source")
    kernels.build_all()
    log(f"[build] {kernels.BUILD_SECONDS:.1f} s")
    for stem, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "entry function" in line):
                log(f"  {stem}: {line.strip()}")


def main() -> int:
    if not (REPO / "pupiloptixlab_tpu_torch").is_dir():
        print("chip_smoke.py: the pupiloptixlab_tpu_torch package is not beside "
              "this script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs one NVIDIA "
              "GPU", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"device": kind, "nvidia_smi": smi}
    t_all = time.perf_counter()

    from pupiloptixlab_tpu_torch import kernels, native

    build(kernels)
    results["build_seconds"] = kernels.BUILD_SECONDS
    results["host_runtime"] = "C++" if native.available() else "numpy"
    log(f"[build] host BVH build and OBJ parser: {results['host_runtime']}")

    t0 = time.perf_counter()
    data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
    log(f"[flatten] mesh_env on cuda in {time.perf_counter() - t0:.2f} s: "
        f"{config.tri_count} tris, {config.bvh_nodes} nodes, tcl {config.bvh_tcl}, "
        f"depth {data.tris.bvh_depth}")
    with torch.inference_mode():
        log("[kernels] K1-K4, each against its plain version")
        bounds = phase_kernels(data, config, cam, results)
        log("[frame] mesh_env BVH route, render_frame, 1 warm-up + 2 timed")
        launches = phase_frame(data, config, cam, results)
        log("[sweep] K3, K4 on oracle_mat's tables; K5 and K6, each against its plain version")
        bounds = phase_sweep((data, config), bounds, results)
    del data
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log("[system] System + PTPass at 1920x1080, depth 4")
        runs = {"mesh_env_bvh": launches}
        runs["oracle_mat"] = phase_system("oracle_mat", ORACLE_MAT, 1, 4, False,
                                          Path(tmp), results)
        torch.cuda.empty_cache()
        runs["mesh_env_nobvh"] = phase_system("mesh_env_nobvh", MESH_ENV, 1, 2, True,
                                              Path(tmp), results)
        torch.cuda.empty_cache()
        bounds["bvh_closest_inst"], bounds["bvh_anyhit_inst"] = Bound(), Bound()
        for name in ("bvh_closest_inst", "bvh_anyhit_inst"):
            results["kernels"][name] = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
                                        "mismatches": 0, "library_ms": None}
        with torch.inference_mode():
            log("[big_env] 405k triangles on K1/K2 at leaf size 32, 1920x1080")
            runs["big_env"], big = phase_big_env(Path(tmp), bounds, results)
            log("[parallel] (e) ring rounds at D=4 on big_env's tables")
            phase_ring_rounds(big, results)
            del big
            torch.cuda.empty_cache()
            log("[instanced] 64 instances through System + PTPass on K7/K8, 1920x1080")
            runs["instanced"], inst_xml = phase_instanced(Path(tmp), bounds, results)
        torch.cuda.empty_cache()
        log("[refit] instance edits through World on the card")
        phase_refit(inst_xml, results)
        torch.cuda.empty_cache()
        ks = results["kernels"]
        for name in ("atrous_iter", "bvh_closest_mt"):
            ks[name] = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0,
                        "library_ms": None}
        with torch.inference_mode():
            log("[denoise] K9 alone on bench.py's inputs at 1920x1080; the other modes of "
                "the denoiser, card against CPU")
            phase_denoise_kernel(results)
            log("[denoise] System + PTPass + DenoisePass on mesh_env at 1920x1080, depth 4")
            runs["mesh_env_denoise"] = phase_denoise_system(Path(tmp), results,
                                                            ks["atrous_iter"], Bound())
            torch.cuda.empty_cache()
            log("[mt32] mesh_env under PUPIL_TCL=32 PUPIL_MXU_MT=1 at 1920x1080 on K10")
            runs["mesh_env_mt32"] = phase_mt32(results, ks["bvh_closest_mt"], Bound())
            torch.cuda.empty_cache()
            log("[parallel] deep soup (K1/K2 at depth 11), K11 and the balanced frame on "
                "mesh_env, rays along box faces, world size 1 over NCCL")
            ks["bvh_closest_count"] = {"library_ms": None}
            runs["mesh_env_balanced"] = phase_parallel(Path(tmp), results,
                                                       ks["bvh_closest_count"], Bound())
    torch.cuda.empty_cache()
    log("[parity] card vs CPU, BVH vs chunk sweep")
    phase_parity(results)
    log("[oracle] 64x64 renders against the brute-force oracles")
    phase_oracle(results)
    t_new = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log("[spectral] dispersion.xml and mesh_env (spectral=True) through System + PTPass")
        phase_spectral(Path(tmp), results)
        torch.cuda.empty_cache()
        log("[sanitizer] mesh_env with debug_checks, clean and with NaN texture colours")
        phase_sanitizer(results)
        torch.cuda.empty_cache()
        log("[restir] ReSTIRPass DI and GI on oracle_mat and mesh_env with an area light")
        phase_restir(Path(tmp), results)
        torch.cuda.empty_cache()
    log("[wavefront] render_wavefront on mesh_env and oracle_mat")
    phase_wavefront(results)
    log("[parity] the new paths, card against CPU")
    phase_new_parity(results)
    results["new_paths_seconds"] = time.perf_counter() - t_new
    log(f"[new paths] {results['new_paths_seconds']:.1f} s")
    t_display = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log("[display] the web client, checkpoints, profiling and ComputePass on the card")
        phase_display(Path(tmp), results)
    torch.cuda.empty_cache()
    results["display_seconds"] = time.perf_counter() - t_display
    log(f"[display] {results['display_seconds']:.1f} s")
    t_batch = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log("[batch] render_frame_batch (one captured sample, replayed) against the eager "
            "loop on every route, its timing and a deferred fault")
        phase_batch(Path(tmp), results)
    results["batch_seconds"] = time.perf_counter() - t_batch
    log(f"[batch] {results['batch_seconds']:.1f} s")

    foreign = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "pupiloptixlab_tpu" or m.startswith("pupiloptixlab_tpu."))
    require(not foreign, f"the port imported {foreign}")
    log("[no-jax] neither jax nor the JAX package was imported")
    results["seconds"] = time.perf_counter() - t_all
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))

    print(json.dumps({"kernels": kernels_line(results, runs)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def check_one_launch(data, rays, results) -> None:
    """Each form of the K3 and K4 wrappers issues exactly one kernel, its
    own, and no cast or copy beside it: one call of each under
    torch.profiler (CUDA activity), each form in a window of its own
    (``one_call_window``), on mesh_env's tables at the first bounce's own
    indices and draws. A window with a kernel other than the form's own, or
    more than one, fails at once; only a window with no record of the call
    (CUPTI dropped it) is repeated, up to LAUNCH_WINDOWS windows in all."""
    import torch

    from pupiloptixlab_tpu_torch.accel import gather as ga

    g, c = rays["gathers"], rays["counts"]
    mats, mat_id, _ = g["materials.params"]
    em = data.emitters
    row = c["env_col_cdf rows"][2]
    forms = {
        "K3 every column": ("gather_planes_kernel", lambda: ga.gather_cols(*g["tris.attrs"][:2])),
        "K3 a column run": ("gather_planes_kernel", lambda: ga.gather_cols(*g["materials.params"])),
        "K3 one column of a strided table": (
            "gather_planes_kernel", lambda: ga.gather_cols(*g["materials.twosided"])),
        "K3 a column list": ("gather_planes_kernel", lambda: ga.gather_cols(
            data.textures.packed, mat_id, (1, 2, 3, 7, 13, 18))),
        "K3 a view with unit strides": (
            "gather_planes_kernel", lambda: ga.gather_cols(*g["env_row_pairs"][:2])),
        "K3 one shared row": ("gather_planes_kernel", lambda: ga.gather_fields(
            data.textures.packed, em.env_radiance_tex.reshape(1), (13,), n=row.shape[0])),
        "K4 shared table": ("count_less_kernel", lambda: ga.count_less(*c["env_row_cdf"])),
        "K4 row-indexed": ("count_less_kernel",
                           lambda: ga.count_less(*c["env_col_cdf rows"][:2], rows=row)),
    }
    for _, fn in forms.values():
        fn()
    torch.cuda.synchronize()
    out, repeated = {}, {}
    for label, (kernel, fn) in forms.items():
        for window in range(1, LAUNCH_WINDOWS + 1):
            names = one_call_window(fn)
            # a real extra or foreign launch shows in every window: fail at once
            require(len(names) <= 1 and all(kernel in n for n in names),
                    f"{label}: the call must launch its own kernel once, got {names}")
            if names:
                break
            log(f"  {label}: window {window} shows no device record (dropped), repeated")
        require(bool(names), f"{label}: no device record in {LAUNCH_WINDOWS} windows")
        repeated[label] = window - 1
        log(f"  {label}: device op {names[0]}")
        out[label] = names[0]
    log(f"  windows repeated for a dropped record: {sum(repeated.values())} "
        f"({repeated})")
    results["one_launch_per_call"] = out
    results["one_launch_windows_repeated"] = repeated


LAUNCH_WINDOWS = 3  # profiler windows a wrapper form may take before its check fails


def one_call_window(fn) -> list:
    """The device kernels of one call of ``fn`` under torch.profiler (CUDA
    activity), in a window of its own, without the sentinel: a
    ``torch.cuda._sleep`` (``spin_kernel``) issued after the call, so that a
    record the profiler flushes late is the sentinel's, not the call's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    return [e.name for e in events if "spin_kernel" not in e.name]


def launch_path_us(results) -> None:
    """Host microseconds a call of the pieces of a wrapper's launch path:
    the current stream's handle two ways, an output allocation, one
    data_ptr, K4's bare ctypes launch, and K4's whole wrapper on a
    1-element query beside searchsorted."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import gather as ga

    dev = torch.device(DEV, torch.cuda.current_device())
    t = torch.zeros(64, device=dev)
    q = torch.zeros(1, device=dev)
    probes = {
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "kernels.stream_ptr": lambda: kernels.stream_ptr(dev),
        "torch.empty": lambda: torch.empty(1, device=dev),
        "data_ptr": t.data_ptr,
        "count_less (1 query)": lambda: ga.count_less(t, q),
        "searchsorted (1 query)": lambda: torch.searchsorted(t, q),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        probes["_cuda_getCurrentRawStream"] = lambda: raw(dev.index)
    # K4's ctypes call alone, its output made once
    k4 = kernels.launcher("count_less")
    o = torch.empty(1, dtype=torch.int32, device=dev)
    args = (t.data_ptr(), 1, 64, 64, q.data_ptr(), None, 1, o.data_ptr(), kernels.stream_ptr(dev))
    probes["K4 ctypes launch alone"] = lambda: k4(*args)
    probes["t.new_empty"] = lambda: t.new_empty(1)
    probes["torch.empty(dtype)"] = lambda: torch.empty(1, dtype=torch.int32, device=dev)
    # a caller's stream: the wrappers launch on it
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        on_side = kernels.stream_ptr(dev) == side.cuda_stream
        got = ga.count_less(t, q)
    side.synchronize()
    require(on_side and int(got[0]) == 0,
            "kernels.stream_ptr must give the stream of a torch.cuda.stream context")
    results["stream_context_honoured"] = on_side
    out = {}
    for name, fn in probes.items():
        fn()
        reps = 2000
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    log(f"  launch path, host us a call: " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    results["launch_path_us"] = out


def main_tables(label: str) -> int:
    """``--tables``: only K3 and K4, at mesh_env's and oracle_mat's shapes
    (phases 3 and 5's cases, each held against its plain version and timed:
    events, device and issue time beside the library call), and the launch
    path's pieces. With ``--package DIR`` the package is imported from DIR,
    so that a parent tree's kernels run under this script's timing in the
    same call. Prints the card's line, then the results as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels

    log(f"[tables] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "package": str(Path(kernels.__file__).parent), "kernels": {}}
    with torch.inference_mode():
        data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
        rays = main_path_rays(data, config, cam)
        bounds = check_mesh_env_tables(data, rays, results)
        check_one_launch(data, rays, results)
        del data, rays
        data, config, cam = load_tables(ORACLE_MAT, *FILM, DEV)
        rays = main_path_rays(data, config, cam)
        check_gathers("oracle_mat", rays["gathers"], results["kernels"]["gather_planes"],
                      bounds["gather_planes"])
        check_counts("oracle_mat", rays["counts"], results["kernels"]["count_less"],
                     bounds["count_less"])
        del data, rays
        launch_path_us(results)
    results["label"] = label
    print(smi)
    print(json.dumps(results))
    return 0


INST_MODE_LANES = 16384  # --inst: lanes held against the plain leaf scan (~3 s a call)


def main_inst(label: str) -> int:
    """``--inst``: only the instanced scene's K7/K8 checks (phase 11's calls
    on the 64-instance scene at 1080p: K7 on primary and bounce rays, K8 on
    shadow rays, each against the plain leaf scan on a seeded subset of
    ``INST_MODE_LANES`` lanes and timed at full N, events and device apart
    from issue), the visits per ray where the package has the counting K7,
    and the sub-leaf gates where it has the sub-leaf level
    (``check_subleaf_gates``). With ``--package DIR`` the package is
    imported from DIR, so that a parent tree's K7/K8 run under this
    script's timing in the same call. Prints the card's line, then the
    results as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.scene.instanced_grid import write_instanced_scene

    log(f"[inst] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "package": str(Path(kernels.__file__).parent), "kernels": {}}
    bounds = {}
    for name in ("bvh_closest_inst", "bvh_anyhit_inst"):
        results["kernels"][name] = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0,
                                    "mismatches": 0, "library_ms": None}
        bounds[name] = Bound()
    with torch.inference_mode(), tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        xml = write_instanced_scene(Path(tmp) / "instanced", SKY, INST_N, INST_GRID, *FILM,
                                    max_depth=4)
        data, config, cam = load_tables(xml, *FILM, DEV)
        rays = main_path_rays(data, config, cam)
        n = config.width * config.height
        lanes = pick_lanes(n, DEV)[:INST_MODE_LANES]
        check_inst_traversal(data, config, rays, lanes, results["kernels"], bounds)
        if "bvh_closest_inst_count" in kernels.KERNELS:
            results["visits"] = inst_visit_counts(data, config, rays)
        if getattr(data.tris, "subleaf_boxes", None) is not None:
            results["subleaf"] = check_subleaf_gates(data, config, cam, rays, lanes)
    results["label"] = label
    print(smi)
    print(json.dumps(results))
    return 0


BVH_MODE_LANES = 8192   # --bvh: lanes of each 1080p ray set held against the brute sweep
VISIT_LANES = 1024      # the counting launcher held against tree_walk on these lanes


def bvh_tables(tris) -> tuple:
    """K1/K2/K11's table arguments after the rays: the reference's four,
    then the sub-leaf table where the package has it (a tree before the
    sub-leaf level, run with --bvh --package, takes four)."""
    tabs = (tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes)
    rows = getattr(tris, "subleaf_rows", None)
    return tabs if rows is None else (*tabs, rows, tris.subleaf_boxes)


def soup_bvh_tables(soup) -> tuple:
    """``bvh_tables`` of the deep soup's dictionary (scene/deep_soup.py)."""
    tabs = (soup["tri"], soup["child"], soup["axis"], soup["boxes"])
    return tabs if "subleaf_rows" not in soup else (
        *tabs, soup["subleaf_rows"], soup["subleaf_boxes"])


def bare_device_ms(name, planes, tabs, scalars, want) -> tuple[float, float]:
    """(device ms, issue ms) of one launch through the kernel's ctypes
    launcher alone (split_time_ms): the traversal wrappers read the fault
    flag after each launch, which waits for the card, so a wrapper call
    cannot run ahead of it. ``scalars`` are the launcher's int arguments;
    the outputs are made like ``want`` (the wrapper's), which the
    launches must reproduce with the flag clear (K11's counts, which the
    repeated launches add up, excepted)."""
    import torch

    from pupiloptixlab_tpu_torch import kernels

    dev = planes[0].device
    outs = [torch.zeros_like(w) for w in want]
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (*(p.data_ptr() for p in planes), *(t.data_ptr() for t in tabs), *scalars,
            *(o.data_ptr() for o in outs), err.data_ptr(), kernels.stream_ptr(dev))
    fn = kernels.launcher(name)
    dev_ms, issue_ms = split_time_ms(lambda: kernels.check(fn(*args), name), reps=5)
    same = all(torch.equal(o, w) for o, w in list(zip(outs, want))[:2])
    require(int(err.item()) == 0 and same,
            f"{name}: the launcher's own calls disagree with the wrapper's")
    return dev_ms, issue_ms


def visits_launch(planes, tabs, tcl: int, n_nodes: int):
    """(t, row, counts) of one launch of ``bvh_closest_visits`` (K1's walk
    with per-tile counts (N / 1024, 4) [pops, leaves, groups, rows]; for
    measurement only) on whole count tiles of ``planes``."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    n = planes[0].shape[0]
    dev = planes[0].device
    t = torch.empty(n, device=dev)
    i = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros((n // bt.COUNT_TILE, 4), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = kernels.launcher("bvh_closest_visits")(
        *(p.data_ptr() for p in planes), *(x.data_ptr() for x in tabs), n, tabs[0].shape[0],
        tcl, n_nodes, t.data_ptr(), i.data_ptr(), counts.data_ptr(), err.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.check(rc, "bvh_closest_visits")
    require(int(err.item()) == 0, "bvh_closest_visits: traversal fault flag")
    return t, i, counts


def bvh_visits(planes, tabs, tcl, depth, n_nodes) -> dict:
    """The work of K1's walk per live ray on whole count tiles of
    ``planes``: inner pops, leaves, sub-leaf groups entered and rows tested,
    from the counting launcher ``bvh_closest_visits`` (measurement only: no
    wrapper, no path launches it), whose (t, row) must equal K1's; a
    package without it (before the sub-leaf level) reports K11's pops and
    leaves, and ``tcl`` rows a leaf, which is what its K1 tests."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    n = planes[0].shape[0] // bt.COUNT_TILE * bt.COUNT_TILE
    full = [p[:n].contiguous() for p in planes]
    t1, i1 = bt.bvh_closest(*full, *tabs, tcl=tcl, depth=depth)
    if "bvh_closest_visits" in kernels.KERNELS:
        t, i, counts = visits_launch(full, tabs, tcl, n_nodes)
        tot = counts.to(torch.int64).sum(dim=0).tolist()
        source = "bvh_closest_visits"
    else:
        t, i, counts = bt.bvh_closest(*full, *tabs, tcl=tcl, depth=depth, count_iters=True)
        tot = counts.to(torch.int64).sum(dim=0).tolist()
        tot = [tot[0], tot[1], None, tot[1] * tcl]
        source = "K11, tcl rows a leaf"
    require(bool(torch.equal(t, t1) and torch.equal(i, i1)),
            "the counting walk disagrees with K1")
    live = max(int((full[7] > full[6]).sum()), 1)
    rec = {"live": live, "hits": int((i1 >= 0).sum()), "source": source,
           "pops_per_ray": tot[0] / live, "leaves_per_ray": tot[1] / live,
           "groups_per_ray": None if tot[2] is None else tot[2] / live,
           "rows_per_ray": tot[3] / live}
    return rec


def bvh_ray_sets(data, config, cam) -> dict:
    """The five 1080p ray sets of one baked scene as planes: the first
    bounce's primary, bounce and shadow rays (main_path_rays), the
    unjittered primary rays and the vertical rays (extra_rays)."""
    rays = main_path_rays(data, config, cam)
    sets = {k: planes_of(rays[k]) for k in ("primary", "bounce", "shadow")}
    sets.update(extra_rays(data, config, cam))
    return sets


def check_bvh_scene(label, data, config, cam, out) -> None:
    """--bvh on one baked scene at 1080p: K1 and K2 on the five ray sets,
    each against the brute sweep on ``BVH_MODE_LANES`` seeded lanes, timed
    at full N (device apart from issue through the bare launchers), the
    work of a ray (bvh_visits), K11's device time on the primary rays, and
    the sub-leaf gates where the package has the sub-leaf level."""
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    tabs = bvh_tables(tr)
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    scal = (tr.packed.shape[0], config.bvh_tcl, tr.bvh_axis.shape[0])
    sets = bvh_ray_sets(data, config, cam)
    n = config.width * config.height
    lanes = pick_lanes(n, DEV)[:BVH_MODE_LANES]
    rec = {"rows": tr.packed.shape[0], "tcl": config.bvh_tcl, "nodes": config.bvh_nodes,
           "depth": tr.bvh_depth, "sets": {}}
    for name, full in sets.items():
        t1, i1 = bt.bvh_closest(*full, *tabs, **kw)
        occ = bt.bvh_anyhit(*full, *tabs, **kw)
        sub = [p[lanes] for p in full]
        t_p, i_p = bt.plain_closest(*sub, tr.packed)
        occ_p = bt.plain_anyhit(*sub, tr.packed)
        off = {"k1_t_off": int((t1[lanes] != t_p).sum()),
               "k1_rows_off": int((i1[lanes] != i_p).sum()),
               "k2_flags_off": int((occ[lanes] != occ_p).sum())}
        require(all(v == 0 for v in off.values()),
                f"--bvh {label} {name}: K1/K2 disagree with the brute sweep: {off}")
        k1_dev, k1_issue = bare_device_ms("bvh_closest", full, tabs, (n, *scal), (t1, i1))
        k2_dev, k2_issue = bare_device_ms("bvh_anyhit", full, tabs, (n, *scal), (occ,))
        s = {"hits": int((i1 >= 0).sum()), "occluded": int(occ.sum()), **off,
             "k1_device_ms": k1_dev, "k1_issue_ms": k1_issue,
             "k2_device_ms": k2_dev, "k2_issue_ms": k2_issue,
             "visits": bvh_visits(full, tabs, config.bvh_tcl, tr.bvh_depth, scal[2])}
        log(f"  {label} {name}: {s}")
        rec["sets"][name] = s
    full = sets["primary"]
    t11, i11, c11 = bt.bvh_closest(*full, *tabs, **kw, count_iters=True)
    rec["k11_device_ms"], rec["k11_issue_ms"] = bare_device_ms(
        "bvh_closest_count", full, tabs, (n, *scal), (t11, i11, c11))
    if len(tabs) == 6:
        rec["subleaf"] = check_bvh_subleaf_gates(label, data, config, sets)
    out[label] = rec


def allpass_table(tabs):
    """The sub-leaf table that makes K1/K2 the full leaf scan, by data and
    not by a flag: the rows of each leaf in table order and every group box
    +-1e30. ``tabs`` is ``bvh_tables``'s six."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    rows, boxes = tabs[4], tabs[5]
    tcl = rows.shape[0] * bt.SUBLEAF_GROUPS // boxes.shape[0]
    order = (torch.arange(rows.shape[0], device=rows.device) % tcl).to(rows.dtype)
    allpass = torch.tensor([-1e30, -1e30, -1e30, 1e30, 1e30, 1e30, 0.0, 0.0],
                           device=boxes.device).expand_as(boxes).contiguous()
    return (*tabs[:4], order, allpass)


def allpass_gate(label, planes, tabs, kw) -> dict:
    """K1 and K2 with the sub-leaf table against the same kernels with the
    all-pass table on every lane of ``planes``: t bit-equal, rows and flags
    equal."""
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    full = allpass_table(tabs)
    t1, i1 = bt.bvh_closest(*planes, *tabs, **kw)
    ta, ia = bt.bvh_closest(*planes, *full, **kw)
    o2 = bt.bvh_anyhit(*planes, *tabs, **kw)
    oa = bt.bvh_anyhit(*planes, *full, **kw)
    rec = {"lanes": planes[0].shape[0], "hits": int((i1 >= 0).sum()),
           "occluded": int(o2.sum()), "k1_t_off": int((t1 != ta).sum()),
           "k1_rows_off": int((i1 != ia).sum()), "k2_flags_off": int((o2 != oa).sum())}
    require(rec["hits"] > 0 and all(v == 0 for k, v in rec.items() if k.endswith("_off")),
            f"K1/K2 with the sub-leaf table disagree with the full leaf scan on {label}: {rec}")
    return rec


def bvh_tie_case():
    """A one-leaf baked table (16 rows, one root node) in which rows 0 and 9
    hold the same triangle T = (0,0,0), (1,0,0), (0,1,0). Along x, 7 rows
    lie below T's centroid and 7 above, so the first median split puts row
    0 and row 9 into different halves, and their groups into different
    groups for 4 or 8 groups a leaf; row 0 shares its group with an
    off-path triangle at z = -1 (row 1), row 9 with one at z = -3 (row 3).
    The rays, from z = -5 along +z through T, enter row 9's group first and
    then row 0's, which starts before the hit. Both rows hit at one t: K1
    must return row 0, as the brute sweep does. Returns (planes, tables,
    tcl)."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tcl = 16

    def tri(x, z):
        return torch.tensor([x, 0.0, z, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])

    packed = torch.zeros((tcl, 12))
    packed[0, 0:9] = packed[9, 0:9] = tri(0.0, 0.0)
    packed[1, 0:9] = tri(-2.5, -1.0)
    packed[3, 0:9] = tri(2.5, -3.0)
    far = [r for r in range(tcl) if r not in (0, 1, 3, 9)]
    for k, r in enumerate(far):  # off-path triangles, 6 far below x = 0, 6 far above
        packed[r, 0:9] = tri(-10.0 * (k + 1) if k < 6 else 10.0 * (k - 5), 0.0)
    boxes = torch.zeros((8, 8))
    boxes[:, 0:6] = 1e30  # empty slots: the never-box
    boxes[0, 0:6] = torch.tensor([-60.0, 0.0, -3.0, 61.0, 1.0, 0.0])
    child = torch.tensor([-1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    packed, boxes, child = (x.to(DEV) for x in (packed, boxes, child))
    rows, sub = bt.make_baked_subleaf(packed, tcl)
    tabs = (packed, child, torch.zeros(1, dtype=torch.int32, device=DEV), boxes, rows, sub)
    g = torch.linspace(0.05, 0.45, 32, device=DEV)
    gx, gy = [a.reshape(-1).contiguous() for a in torch.meshgrid(g, g, indexing="ij")]
    n = gx.shape[0]
    planes = [gx, gy, torch.full((n,), -5.0, device=DEV), torch.zeros(n, device=DEV),
              torch.zeros(n, device=DEV), torch.ones(n, device=DEV),
              torch.full((n,), 1e-3, device=DEV), torch.full((n,), 1e16, device=DEV)]
    return planes, tabs, tcl


def check_bvh_subleaf_gates(label, data, config, sets) -> dict:
    """K1/K2 with the sub-leaf table against the all-pass table on every
    lane of each 1080p ray set of one scene (allpass_gate), then the
    cross-group tie (bvh_tie_case), which K1 must give to the lower row,
    and the counting launcher against tree_walk's counts on
    ``VISIT_LANES`` primary rays."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    tabs = bvh_tables(tr)
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    out = {}
    for name, full in sets.items():
        out[name] = allpass_gate(f"{label} {name}", full, tabs, kw)
        log(f"  sub-leaf {label} {name}: {out[name]}")
    planes, ttabs, tcl = bvh_tie_case()
    rows = ttabs[4].long()
    group = {int(rows[j]): j // (tcl // bt.SUBLEAF_GROUPS) for j in range(tcl)}
    t1, i1 = bt.bvh_closest(*planes, *ttabs, tcl=tcl, depth=1)
    tp, ip = bt.plain_closest(*planes, ttabs[0])
    occ = bt.bvh_anyhit(*planes, *ttabs, tcl=tcl, depth=1)
    tie = {"lanes": planes[0].shape[0], "groups_of_rows_0_9": [group[0], group[9]],
           "rows": sorted(set(i1.tolist())), "plain_rows": sorted(set(ip.tolist())),
           "t_equal_plain": bool(torch.equal(t1, tp)), "occluded": int(occ.sum())}
    log(f"  sub-leaf tie across groups: {tie}")
    require(group[0] != group[9] and tie["rows"] == [0] and tie["plain_rows"] == [0]
            and tie["t_equal_plain"] and tie["occluded"] == tie["lanes"],
            "K1 must keep the lower row of a tie across sub-leaf groups")
    out["tie"] = tie
    # the counting launcher against tree_walk on seeded primary rays
    lanes = pick_lanes(sets["primary"][0].shape[0], DEV)[:VISIT_LANES]
    sub = [p[lanes].contiguous() for p in sets["primary"]]
    walk = bt.tree_walk(*sub, *tabs, config.bvh_tcl)
    want = [int(walk[k].sum()) for k in ("pops", "leaves", "groups", "rows")]
    t, i, counts = visits_launch(sub, tabs, config.bvh_tcl, tr.bvh_axis.shape[0])
    got = counts.to(torch.int64).sum(0).tolist()
    vis = {"lanes": VISIT_LANES, "walk": want, "launcher": got,
           "t_equal": bool(torch.equal(t, walk["t"])),
           "rows_equal": bool(torch.equal(i, walk["idx"]))}
    log(f"  visits {label}: counting launcher against tree_walk {vis}")
    require(got == want and vis["t_equal"] and vis["rows_equal"],
            "the counting launcher disagrees with tree_walk's counts")
    out["visits_vs_walk"] = vis
    return out


def check_deep_soup_bvh(out) -> None:
    """--bvh on the deep soup (scene/deep_soup.py, 65,536 rays): K1/K2
    against the brute sweep on every ray, device times, the work of a ray,
    and the all-pass gate where the package has the sub-leaf level."""
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.scene.deep_soup import soup_rays, soup_tables

    soup = soup_tables(device=DEV)
    tabs = soup_bvh_tables(soup)
    kw = dict(tcl=soup["tcl"], depth=soup["depth"])
    planes = soup_rays(soup["tri"], SUBSET)
    scal = (soup["tri"].shape[0], soup["tcl"], soup["n_nodes"])
    t1, i1 = bt.bvh_closest(*planes, *tabs, **kw)
    occ = bt.bvh_anyhit(*planes, *tabs, **kw)
    t_p, i_p = bt.plain_closest(*planes, soup["tri"])
    occ_p = bt.plain_anyhit(*planes, soup["tri"])
    rec = {"rows": soup["tri"].shape[0], "tcl": soup["tcl"], "depth": soup["depth"],
           "hits": int((i_p >= 0).sum()), "k1_t_off": int((t1 != t_p).sum()),
           "k1_rows_off": int((i1 != i_p).sum()), "k2_flags_off": int((occ != occ_p).sum())}
    require(all(v == 0 for k, v in rec.items() if k.endswith("_off")),
            f"--bvh deep soup: K1/K2 disagree with the brute sweep: {rec}")
    rec["k1_device_ms"], rec["k1_issue_ms"] = bare_device_ms(
        "bvh_closest", planes, tabs, (SUBSET, *scal), (t1, i1))
    rec["k2_device_ms"], rec["k2_issue_ms"] = bare_device_ms(
        "bvh_anyhit", planes, tabs, (SUBSET, *scal), (occ,))
    rec["visits"] = bvh_visits(planes, tabs, soup["tcl"], soup["depth"], scal[2])
    if len(tabs) == 6:
        rec["allpass"] = allpass_gate("deep soup", planes, tabs, kw)
    log(f"  deep soup: {rec}")
    out["deep_soup"] = rec


def main_bvh(label: str) -> int:
    """``--bvh``: only the K1/K2/K11 checks, on mesh_env and big_env at
    1080p (five ray sets each: check_bvh_scene) and on the deep soup's
    65,536 rays. With ``--package DIR`` the package is imported from DIR, so
    that a parent tree's kernels run under this script's timing in the same
    call. big_env is generated once into ``_work/bvh_mode`` (gitignored) and
    reused by later runs of the same call. Prints the card's line, then the
    results as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels

    log(f"[bvh] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "package": str(Path(kernels.__file__).parent), "label": label,
                     "registers": {stem: [ln.strip() for ln in text.splitlines()
                                          if "registers" in ln or "spill" in ln
                                          or "entry function" in ln]
                                   for stem, text in kernels.BUILD_LOG.items()
                                   if stem == "bvh_traverse"}}
    big_dir = REPO / "_work" / "bvh_mode"
    if not (big_dir / "big_env.xml").exists():
        subprocess.run([sys.executable, str(REPO / "tools" / "make_big_scene.py"),
                        str(big_dir), str(BIG_GRID)], check=True, capture_output=True,
                       timeout=600)
    with torch.inference_mode():
        for name, xml in (("mesh_env", MESH_ENV),
                          ("big_env", scene_copy(big_dir / "big_env.xml", *FILM, big_dir))):
            data, config, cam = load_tables(xml, *FILM, DEV)
            check_bvh_scene(name, data, config, cam, results)
            del data
            torch.cuda.empty_cache()
        check_deep_soup_bvh(results)
    print(smi)
    print(json.dumps(results))
    return 0


SWEEP_MODE_LANES = 8192  # --sweep: lanes of each 1080p ray set held against the plain sweep
SOUP_ROWS = (128, 512, 1024, 2560)  # the seeded soups' table rows (make_soup)


def sweep_args(tri, chunk_boxes, rows: int) -> tuple:
    """(tables, keywords) of the sweep wrappers of the package in use:
    (tri, its sweep_boxes) and ``rows=`` where the package builds that box
    table; (tri, the chunk boxes, their super-boxes) and nothing for an
    earlier one (run with --sweep --package), its super-boxes built once
    here as its flatten built them."""
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.accel import sweep as sw

    if hasattr(bt, "sweep_boxes"):
        return (tri, bt.sweep_boxes(tri)), {"rows": rows}
    return (tri, chunk_boxes, sw.super_boxes(chunk_boxes)), {}


def live_box(boxes) -> tuple:
    """(lo, hi) over the chunk boxes that hold a row (lo <= hi)."""
    real = boxes[boxes[:, 0] <= boxes[:, 3]]
    return real[:, 0:3].amin(0), real[:, 3:6].amax(0)


def sweep_visits(planes, tri, boxes, rows: int, want) -> dict:
    """The work of K5 per live ray: chunks whose box it enters, chunks it
    tests, rows it tests and rows below ``rows`` it tests, from the
    counting launcher ``sweep_closest_visits`` (measurement only: no
    wrapper, no path launches it), whose (t, row) must equal K5's
    (``want``)."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import sweep as sw

    n = planes[0].shape[0]
    t = torch.empty(n, device=DEV)
    i = torch.empty(n, dtype=torch.int32, device=DEV)
    counts = torch.zeros((n, 4), dtype=torch.int32, device=DEV)
    rc = kernels.launcher("sweep_closest_visits")(
        *(p.data_ptr() for p in planes), tri.data_ptr(), boxes.data_ptr(), n,
        tri.shape[0] // sw.CHUNK, rows, t.data_ptr(), i.data_ptr(), counts.data_ptr(),
        kernels.stream_ptr(tri.device))
    kernels.check(rc, "sweep_closest_visits")
    require(bool(torch.equal(t, want[0]) and torch.equal(i, want[1])),
            "the counting sweep disagrees with K5")
    live = planes[7] > planes[6]
    n_live = max(int(live.sum()), 1)
    tot = counts[live].to(torch.int64).sum(0).tolist()
    return {"live": n_live, "entered_per_ray": tot[0] / n_live,
            "chunks_per_ray": tot[1] / n_live, "rows_per_ray": tot[2] / n_live,
            "live_rows_per_ray": tot[3] / n_live}


def allpass_boxes(boxes):
    """Boxes that every ray enters (+-1e30), in the shape of a sweep_boxes
    table: with ``rows=`` the table's row count they make K5/K6 the full
    scan, by data and not by a flag."""
    import torch

    return torch.tensor([-1e30, -1e30, -1e30, 1e30, 1e30, 1e30, 0.0, 0.0],
                        device=boxes.device).expand_as(boxes).contiguous()


def sweep_full_scan_gate(label, planes, tri, boxes, rows: int) -> dict:
    """K5 and K6 on the live rows with their sweep_boxes against the same
    kernels at rows = T with all-pass boxes (the full scan) on every lane
    of ``planes``: t bit-equal, rows and flags equal."""
    import torch

    from pupiloptixlab_tpu_torch.accel import sweep as sw

    ab = allpass_boxes(boxes)
    t, i = sw.sweep_closest(*planes, tri, boxes, rows=rows)
    ta, ia = sw.sweep_closest(*planes, tri, ab, rows=tri.shape[0])
    o = sw.sweep_anyhit(*planes, tri, boxes, rows=rows)
    oa = sw.sweep_anyhit(*planes, tri, ab, rows=tri.shape[0])
    rec = {"lanes": planes[0].shape[0], "hits": int((i >= 0).sum()),
           "occluded": int(o.sum()), "k5_t_off": int((t != ta).sum()),
           "k5_rows_off": int((i != ia).sum()), "k6_flags_off": int((o != oa).sum())}
    require(bool(torch.equal(t, ta)) and all(v == 0 for k, v in rec.items()
                                             if k.endswith("_off")),
            f"K5/K6 disagree with their full scan on {label}: {rec}")
    return rec


TIE_CASES = {
    # chunks: (rows holding the tied triangle, the off-path triangle's row)
    2: ((5, 70), 100),            # one group: table order
    34: ((5, 2051, 2118), 2152),  # two groups: nearest first, groups and chunks
}


def sweep_tie_case(n_chunks: int):
    """A table of ``n_chunks`` chunks in which the rows of
    ``TIE_CASES[n_chunks]`` hold the same triangle T = (0,0,0), (1,0,0),
    (0,1,0), beside off-path triangles at x = +-20 in chunk 0. One off-path
    triangle at z = -3 sits in the last tied row's chunk, so the rays, from
    z = -5 along +z through T, enter that chunk's box (and its group's
    super-box) at t = 2 and the other tied rows' at t = 5: nearest first,
    the last tied row is found first. Every tied row hits at t = 5; K5 must
    return row 5, as the plain sweep does. Returns (planes, tri, its
    sweep_boxes, live rows)."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    def tri(x, z):
        return torch.tensor([x, 0.0, z, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])

    tied, off = TIE_CASES[n_chunks]
    packed = torch.zeros((n_chunks * 64, 12))
    for row in tied:
        packed[row, 0:9] = tri(0.0, 0.0)
    packed[2, 0:9] = tri(-20.0, 0.0)
    packed[9, 0:9] = tri(20.0, 0.0)
    packed[off, 0:9] = tri(2.5, -3.0)
    g = torch.linspace(0.05, 0.45, 32)
    gx, gy = [a.reshape(-1).contiguous() for a in torch.meshgrid(g, g, indexing="ij")]
    n = gx.shape[0]
    planes = [gx, gy, torch.full((n,), -5.0), torch.zeros(n), torch.zeros(n), torch.ones(n),
              torch.full((n,), 1e-3), torch.full((n,), 1e16)]
    packed = packed.to(DEV)
    return [p.to(DEV) for p in planes], packed, bt.sweep_boxes(packed), off + 1


def check_sweep_tie() -> dict:
    """K5 on each sweep_tie_case: the lowest row of a tie across chunks (2
    chunks, table order) and across groups and chunks (34 chunks, nearest
    first), t equal to the plain sweep's; K6 occludes every lane."""
    import torch

    from pupiloptixlab_tpu_torch.accel import sweep as sw

    out = {}
    for n_chunks in TIE_CASES:
        planes, tri, boxes, live = sweep_tie_case(n_chunks)
        t, i = sw.sweep_closest(*planes, tri, boxes, rows=live)
        tp, ip = sw.plain_sweep_closest(*planes, tri)
        occ = sw.sweep_anyhit(*planes, tri, boxes, rows=live)
        tie = {"lanes": planes[0].shape[0], "rows": sorted(set(i.tolist())),
               "plain_rows": sorted(set(ip.tolist())),
               "t_equal_plain": bool(torch.equal(t, tp)), "occluded": int(occ.sum())}
        log(f"  sweep tie across {n_chunks} chunks: {tie}")
        require(tie["rows"] == [5] and tie["plain_rows"] == [5] and tie["t_equal_plain"]
                and tie["occluded"] == tie["lanes"],
                f"K5 must keep the lowest row of a tie across {n_chunks} chunks")
        out[f"chunks_{n_chunks}"] = tie
    return out


def sweep_case(label, tri, chunk_boxes, rows: int, sets, lanes, out) -> None:
    """--sweep on one table: K5 and K6 on each ray set, against the plain
    sweep on ``lanes``, device time apart from issue time (split_time_ms
    around the wrappers, which read no fault flag), the work of a ray
    (sweep_visits) where the package has the counting launcher, and the
    full-scan gate where its wrappers take ``rows=``."""
    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import sweep as sw

    tabs, kw = sweep_args(tri, chunk_boxes, rows)
    n_chunks = tri.shape[0] // sw.CHUNK
    rec = {"rows": tri.shape[0], "live_rows": rows, "chunks": n_chunks,
           "groups": sw.group_count(n_chunks), "sets": {}}
    for name, full in sets.items():
        t5, i5 = sw.sweep_closest(*full, *tabs, **kw)
        occ = sw.sweep_anyhit(*full, *tabs, **kw)
        sub = [p[lanes] for p in full]
        t_p, i_p = sw.plain_sweep_closest(*sub, tri)
        occ_p = sw.plain_sweep_anyhit(*sub, tri)
        off = {"k5_t_off": int((t5[lanes] != t_p).sum()),
               "k5_rows_off": int((i5[lanes] != i_p).sum()),
               "k6_flags_off": int((occ[lanes] != occ_p).sum())}
        require(all(v == 0 for v in off.values()),
                f"--sweep {label} {name}: K5/K6 disagree with the plain sweep: {off}")
        k5_dev, k5_issue = split_time_ms(lambda: sw.sweep_closest(*full, *tabs, **kw), reps=5)
        k6_dev, k6_issue = split_time_ms(lambda: sw.sweep_anyhit(*full, *tabs, **kw), reps=5)
        s = {"hits": int((i5 >= 0).sum()), "occluded": int(occ.sum()), **off,
             "k5_device_ms": k5_dev, "k5_issue_ms": k5_issue,
             "k6_device_ms": k6_dev, "k6_issue_ms": k6_issue}
        if kw:
            if "sweep_closest_visits" in kernels.KERNELS:
                s["visits"] = sweep_visits(full, *tabs, rows, (t5, i5))
            s["full_scan"] = sweep_full_scan_gate(f"{label} {name}", full, *tabs, rows)
        log(f"  {label} {name}: {s}")
        rec["sets"][name] = s
    out[label] = rec


def sweep_scenes():
    """The tables of --sweep and of phase 5's full-scan gates, one at a time,
    as (label, tri, chunk boxes, live rows, ray sets as planes): oracle_mat's
    own table, the seeded soups of ``SOUP_ROWS`` rows in its stage under its
    rays, and mesh_env flattened under PUPIL_NO_BVH; the ray sets are the
    first bounce's primary, bounce and shadow rays, the unjittered primary
    rays and vertical rays over the table's live box, all at 1920x1080."""
    data, config, cam = load_tables(ORACLE_MAT, *FILM, DEV)
    require(config.bvh_nodes == 0, "oracle_mat must take the chunk sweep")
    rays = main_path_rays(data, config, cam)
    sets = {k: planes_of(rays[k]) for k in ("primary", "bounce", "shadow")}
    sets.update(extra_rays(data, config, cam, box=live_box(data.tris.chunk_boxes)))
    yield "oracle_mat", data.tris.packed, data.tris.chunk_boxes, config.tri_count, sets
    del data, rays
    for rows in SOUP_ROWS:
        tri, boxes, live = make_soup(rows, DEV)
        soup_sets = {**sets, "vertical": vertical_rays(*live_box(boxes), *FILM)}
        yield f"soup_{rows}", tri, boxes, live, soup_sets
    del sets, soup_sets
    data, config, cam = load_tables(MESH_ENV, *FILM, DEV, no_bvh=True)
    require(config.bvh_nodes == 0 and data.tris.chunk_boxes.shape[0] == 321,
            "mesh_env under PUPIL_NO_BVH must take the 321-chunk sweep")
    rays = main_path_rays(data, config, cam)
    sets = {k: planes_of(rays[k]) for k in ("primary", "bounce", "shadow")}
    sets.update(extra_rays(data, config, cam, box=live_box(data.tris.chunk_boxes)))
    yield "mesh_env_nobvh", data.tris.packed, data.tris.chunk_boxes, config.tri_count, sets


def main_sweep(label: str) -> int:
    """``--sweep``: only the K5/K6 checks, on every table of sweep_scenes
    (oracle_mat, the soups of ``SOUP_ROWS`` rows, mesh_env under
    PUPIL_NO_BVH) at 1080p with five ray sets each (sweep_case), the ties
    across chunks and groups where the wrappers take ``rows=``, and the
    ring's rounds on big_env (phase 16 (e), timed four times). With ``--package
    DIR`` the package is imported from DIR, so that a parent tree's kernels
    run under this script's timing in the same call. Prints the card's
    line, then the results as one JSON line (with the ptxas register lines
    of sweep.cu)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    log(f"[sweep] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "package": str(Path(kernels.__file__).parent), "label": label,
                     "registers": [ln.strip() for ln in kernels.BUILD_LOG.get("sweep", "")
                                   .splitlines() if "registers" in ln or "spill" in ln
                                   or "entry function" in ln]}
    lanes = pick_lanes(FILM[0] * FILM[1], DEV)[:SWEEP_MODE_LANES]
    with torch.inference_mode():
        for case, tri, boxes, rows, sets in sweep_scenes():
            sweep_case(case, tri, boxes, rows, sets, lanes, results)
            torch.cuda.empty_cache()
        if hasattr(bt, "sweep_boxes"):
            results["tie"] = check_sweep_tie()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            data, config, cam = load_big_env(Path(tmp))[:3]
            phase_ring_rounds((data, config, cam), results, reps=4)
    print(smi)
    print(json.dumps(results))
    return 0


MT_MODE_SHARES = (2, 4, 8, 12, 16, 20, 24, 28, 32)  # thresholds the share histogram is read at
MT_TIMED_SHARES = (1, 2, 4, 8, 16, 33)  # --mt: K10 timed at these share thresholds
MT_EVERY_LEAF = 1  # a share threshold every pending leaf reaches: the path's form
MT_ALL_CUDA_CORES = 33  # a share threshold no leaf reaches: every leaf on the CUDA cores


def ptxas_lines(kernels, stem: str) -> list:
    """The ptxas register, spill and entry lines of one source's build (empty
    when this run did not build it)."""
    return [ln.strip() for ln in kernels.BUILD_LOG.get(stem, "").splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def mt_launch_tables(tr, config) -> tuple:
    """(tables, scalars after n) of K10's bare launcher for the package in
    use: the linear-form tables, the tree, then the launcher's ints (a
    package whose K10 has no tensor-core filter takes (mt_rows, center) and
    (T, tcl, nodes))."""
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    n_nodes = tr.bvh_axis.shape[0]
    tree = (tr.bvh_child, tr.bvh_axis, tr.bvh_boxes)
    if hasattr(bt, "mt_kernel_tables"):
        return (*bt.mt_kernel_tables(tr.packed), *tree), (tr.packed.shape[0], n_nodes)
    return (*bt.mt_tables(tr.packed), *tree), (tr.packed.shape[0], config.bvh_tcl, n_nodes)


def mt_launch(planes, tr, share_min: int):
    """(t, row) of one launch of ``bvh_closest_mt_at``, K10 with only the
    leaves that at least ``share_min`` lanes of a warp share on the tensor
    cores, the fault flag clear."""
    import torch

    from pupiloptixlab_tpu_torch import kernels

    tabs, scal = mt_launch_tables(tr, None)
    n = planes[0].shape[0]
    dev = planes[0].device
    t = torch.empty(n, device=dev)
    i = torch.empty(n, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = kernels.launcher("bvh_closest_mt_at")(
        *(p.data_ptr() for p in planes), *(x.data_ptr() for x in tabs), n, *scal, share_min,
        t.data_ptr(), i.data_ptr(), err.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "bvh_closest_mt_at")
    require(int(err.item()) == 0, "bvh_closest_mt_at: traversal fault flag")
    return t, i


def check_mt_tc_gate(data, config, cam) -> dict:
    """K10 with its tensor-core filter (the wrapper: every pending leaf
    through it) against the same kernel with every leaf on the CUDA cores
    (``bvh_closest_mt_at`` at MT_ALL_CUDA_CORES) on all 2,073,600 lanes of the
    five 1080p ray sets (bvh_ray_sets): t bit-equal, rows equal; and the
    share of the lane-leaf tests the tensor cores served (mt_visits), which
    must not be 0 on the primary rays."""
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tr = data.tris
    kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
    out = {}
    for name, full in bvh_ray_sets(data, config, cam).items():
        t_k, i_k = bt.bvh_closest_mt(*full, tr.packed, tr.bvh_child, tr.bvh_axis,
                                     tr.bvh_boxes, **kw)
        t_c, i_c = mt_launch(full, tr, MT_ALL_CUDA_CORES)
        vis = mt_visits(full, tr, config, MT_EVERY_LEAF)
        rec = {"t_off": int((t_k != t_c).sum()), "rows_off": int((i_k != i_c).sum()),
               "hits": int((i_k >= 0).sum()), "tc_share": vis["tc_share"],
               "leaves_per_ray": vis["leaves_per_ray"],
               "rows_tested_per_ray": vis["rows_tested_per_ray"],
               "rows_passed_per_tc_test": vis["tc_rows_passed"] / max(vis["tc_lane_tests"], 1)}
        log(f"  K10 tensor cores against CUDA cores alone, {name}: {rec}")
        require(rec["t_off"] == 0 and rec["rows_off"] == 0,
                f"K10 {name}: the tensor-core filter changed a result: {rec}")
        out[name] = rec
    require(out["primary"]["tc_share"] > 0,
            "K10: no leaf test of the primary rays went to the tensor cores")
    return out


def mt_visits(planes, tr, config, share_min: int) -> dict:
    """K10's walk counted on whole count tiles of ``planes`` by the
    measurement launcher ``bvh_closest_mt_visits`` at the share threshold
    ``share_min`` (lanes of a warp that must share a pending leaf for it
    to be tested on the tensor cores; 33: none is), its (t, row) held
    against K10's: per live ray the pops and leaves, per warp leaf step the
    lanes with a pending leaf, the histogram of pending leaves by the lanes
    sharing them, and the share of lane-leaf tests at each threshold of
    ``MT_MODE_SHARES``; where the kernel has the tensor-core filter, the
    products, the lane-leaf tests they served and the rows that passed the
    filter."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    n = planes[0].shape[0] // bt.COUNT_TILE * bt.COUNT_TILE
    full = [p[:n].contiguous() for p in planes]
    t_k, i_k = bt.bvh_closest_mt(*full, tr.packed, tr.bvh_child, tr.bvh_axis, tr.bvh_boxes,
                                 tcl=bt.MT_TCL, depth=tr.bvh_depth)
    tabs = mt_launch_tables(tr, config)[0]
    dev = full[0].device
    t = torch.empty(n, device=dev)
    i = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros((n // bt.COUNT_TILE, 40), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    rc = kernels.launcher("bvh_closest_mt_visits")(
        *(p.data_ptr() for p in full), *(x.data_ptr() for x in tabs), n, tr.packed.shape[0],
        tr.bvh_axis.shape[0], share_min, t.data_ptr(), i.data_ptr(), counts.data_ptr(),
        err.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "bvh_closest_mt_visits")
    require(int(err.item()) == 0 and torch.equal(t, t_k) and torch.equal(i, i_k),
            "bvh_closest_mt_visits: the counting walk disagrees with K10")
    tot = counts.to(torch.int64).sum(dim=0).tolist()
    hist = tot[8:]
    lane_tests = sum((c + 1) * h for c, h in enumerate(hist))
    live = max(int((full[7] > full[6]).sum()), 1)
    steps = max(tot[2], 1)
    rec = {"live": live, "hits": int((i_k >= 0).sum()), "share_min": share_min,
           "pops_per_ray": tot[0] / live, "leaves_per_ray": tot[1] / live,
           "warp_steps": tot[2], "pending_lanes_per_step": tot[1] / steps,
           "leaves_per_step": sum(hist) / steps,
           "tc_products": tot[3], "tc_lane_tests": tot[4], "tc_rows_passed": tot[5],
           "rows_tested_per_ray": tot[6] / live,
           "tc_share": tot[4] / max(tot[1], 1),
           "hist": {c + 1: h for c, h in enumerate(hist) if h},
           "lane_share_at": {m: sum((c + 1) * h for c, h in enumerate(hist) if c + 1 >= m)
                             / max(lane_tests, 1) for m in MT_MODE_SHARES},
           "products_per_step_at": {m: sum(h for c, h in enumerate(hist) if c + 1 >= m) / steps
                                    for m in MT_MODE_SHARES}}
    return rec


def main_mt(label: str) -> int:
    """``--mt``: only the K10 checks, on mesh_env flattened under
    PUPIL_TCL=32 at 1080p with its five ray sets (bvh_ray_sets): K10
    against the brute linear-form sweep on ``BVH_MODE_LANES`` seeded lanes
    (rows equal, t bit-equal) and against K1 on the same tables
    (compare_mt_k1's counts), device and issue time of K10 and of K1 from
    the bare launchers (split_time_ms), and where the package has the
    counting launcher, the walk's counts at the shipped threshold and with
    every leaf on the CUDA cores (mt_visits). With ``--package DIR`` the
    package is imported from DIR, so that a parent tree's kernels run under
    this script's timing in the same call. Prints the card's line, then the
    results as one JSON line (with the ptxas lines of the sources this run
    built)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    log(f"[mt] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "package": str(Path(kernels.__file__).parent), "label": label,
                     "registers": {stem: ptxas_lines(kernels, stem)
                                   for stem in kernels.BUILD_LOG}, "sets": {}}
    with torch.inference_mode():
        with pupil_env("PUPIL_TCL", "32"):
            data, config, cam = load_tables(MESH_ENV, *FILM, DEV)
        tr = data.tris
        require(config.bvh_tcl == bt.MT_TCL, "--mt: expected 32-row leaves")
        kw = dict(tcl=config.bvh_tcl, depth=tr.bvh_depth)
        tree = (tr.packed, tr.bvh_child, tr.bvh_axis, tr.bvh_boxes)
        tabs, scal = mt_launch_tables(tr, config)
        k1_tabs = bvh_tables(tr)
        k1_scal = (tr.packed.shape[0], config.bvh_tcl, tr.bvh_axis.shape[0])
        n = config.width * config.height
        lanes = pick_lanes(n, DEV)[:BVH_MODE_LANES]
        results.update(rows=tr.packed.shape[0], nodes=config.bvh_nodes, depth=tr.bvh_depth)
        for name, full in bvh_ray_sets(data, config, cam).items():
            t_k, i_k = bt.bvh_closest_mt(*full, *tree, **kw)
            sub = [p[lanes] for p in full]
            t_p, i_p = bt.plain_closest_mt(*sub, tr.packed)
            off = {"t_off": int((t_k[lanes] != t_p).sum()),
                   "rows_off": int((i_k[lanes] != i_p).sum())}
            require(off["t_off"] == 0 and off["rows_off"] == 0,
                    f"--mt {label} {name}: K10 disagrees with its plain version: {off}")
            t1, i1 = bt.bvh_closest(*full, *k1_tabs, **kw)
            vs_k1 = compare_mt_k1(tr.packed, bt.mt_tables(tr.packed)[1], full, t_k, i_k, t1, i1)
            dev_ms, issue_ms = bare_device_ms("bvh_closest_mt", full, tabs, (n, *scal),
                                              (t_k, i_k))
            k1_dev, _ = bare_device_ms("bvh_closest", full, k1_tabs, (n, *k1_scal), (t1, i1))
            s = {"hits": int((i_k >= 0).sum()), **off, "device_ms": dev_ms,
                 "issue_ms": issue_ms, "k1_device_ms": k1_dev,
                 "vs_k1": {k: v for k, v in vs_k1.items() if k != "t_off_lanes"}}
            if "bvh_closest_mt_at" in kernels.KERNELS:  # the device time at each share threshold
                s["device_ms_at"] = {
                    m: bare_device_ms("bvh_closest_mt_at", full, tabs, (n, *scal, m),
                                      (t_k, i_k))[0] for m in MT_TIMED_SHARES}
            if "bvh_closest_mt_visits" in kernels.KERNELS:
                s["visits"] = mt_visits(full, tr, config, MT_EVERY_LEAF)
                s["visits_cuda_cores"] = mt_visits(full, tr, config, MT_ALL_CUDA_CORES)
            log(f"  mt32 {name}: {s}")
            results["sets"][name] = s
        del data
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(results))
    return 0


def main_atrous(label: str) -> int:
    """``--atrous``: only the K9 checks, on bench.py's denoiser inputs at
    1920x1080 (denoise_inputs), guided and unguided: each of the 5 launches
    of a denoise (steps 1-16) against its plain version on the same planes
    (atol 2e-6, rtol 1e-5), its device and issue time apart around the
    wrapper (split_time_ms; K9's wrapper reads nothing back) and its events
    time, then the denoise (atrous_denoise_cuda) against the plain filter
    and timed. With ``--package DIR`` as ``--mt``. Prints the card's line,
    then the results as one JSON line (with the ptxas lines of the sources
    this run built)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.denoise import atrous_kernel as tk

    log(f"[atrous] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "package": str(Path(kernels.__file__).parent), "label": label,
                     "registers": {stem: ptxas_lines(kernels, stem)
                                   for stem in kernels.BUILD_LOG}}
    with torch.inference_mode():
        color, albedo, normal = denoise_inputs(*FILM, DEV)
        a, nrm = tk.planes_of(albedo), tk.planes_of(normal)
        for guided in (True, False):
            flags = dict(use_albedo=guided, use_normal=guided)
            x = tk.planes_of(color)
            rec = {"steps": []}
            for it in range(DENOISE_ITERS):
                step = 1 << it
                got = tk.atrous_iter(x, a, nrm, step, **flags)
                want = tk.atrous_iter_plain(x, a, nrm, step, **flags)
                err = float((got - want).abs().max())
                require(bool(torch.allclose(got, want, atol=2e-6, rtol=1e-5)),
                        f"--atrous {label} step {step}: K9 disagrees with its plain version")
                dev_ms, issue_ms = split_time_ms(
                    lambda: tk.atrous_iter(x, a, nrm, step, **flags))
                ms = cuda_time_ms(lambda: tk.atrous_iter(x, a, nrm, step, **flags), reps=10)
                rec["steps"].append({"step": step, "max_abs_err": err, "device_ms": dev_ms,
                                     "issue_ms": issue_ms, "ms": ms})
                x = want
            got = tk.atrous_denoise_cuda(color, albedo, normal, **flags)
            want = plain_denoise(color, albedo, normal, guided)
            require(bool(torch.allclose(got, want, atol=2e-6, rtol=1e-5)),
                    f"--atrous {label}: the denoise disagrees with the plain filter")
            kernels.reset_launches()
            rec["denoise_ms"] = cuda_time_ms(
                lambda: tk.atrous_denoise_cuda(color, albedo, normal, **flags), reps=10)
            rec["launches_per_denoise"] = kernels.LAUNCHES["atrous_iter"] / 11
            rec["denoise_device_ms"], rec["denoise_issue_ms"] = split_time_ms(
                lambda: tk.atrous_denoise_cuda(color, albedo, normal, **flags))
            rec["denoise_max_abs_err"] = float((got - want).abs().max())
            log(f"  atrous {'guided' if guided else 'unguided'}: {rec}")
            results["guided" if guided else "unguided"] = rec
    print(smi)
    print(json.dumps(results))
    return 0


def kernels_line(results, runs) -> list:
    """Each kernel's launches over the runs of the main paths it is on (each
    run had the counts set to 0 just before and read just after): the paths
    whose shapes its ms, plain_ms and bound_ms were taken at."""
    line = []
    for name, (source, replaces) in KERNEL_META.items():
        k = results["kernels"][name]
        by_path = {path: runs[path][name] for path in PATHS_OF[name]}
        require(all(v > 0 for v in by_path.values()),
                f"{name} was not launched on a path it is counted on: {by_path}")
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            **({"row_form": k["row_form"]} if "row_form" in k else {}),
        })
    return line


def main_display(label: str) -> int:
    """``--display``: only phase 22 (phase_display: the web client on
    mesh_env at 1080p, the checkpoint resume, FrameStats and a trace, the
    compute pass card against CPU), on a package that has the display
    modules (PR 13 or later). Prints the card's line, then the phase's
    results as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels

    log(f"[display] {label}: package {Path(kernels.__file__).parent}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "label": label}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_display(Path(tmp), results)
    results["seconds"] = time.perf_counter() - t0
    print(smi)
    print(json.dumps(results))
    return 0


def main_batch(label: str) -> int:
    """``--batch``: only phase 23 (phase_batch: render_frame_batch against
    the eager loop on every route at 1080p, the two forms timed, a fault
    raised after the replays), on a package that has render_frame_batch.
    Prints the card's line, then the phase's results as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels

    log(f"[batch] {label}: package {Path(kernels.__file__).parent}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "label": label}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phase_batch(Path(tmp), results)
    results["seconds"] = time.perf_counter() - t0
    print(smi)
    print(json.dumps(results))
    return 0


# --bsdf: the planes each type's lane loads in csrc/bsdf.cu (load_mat), and
# their bytes: reflectance, specular, transmittance, eta3 + k3, alpha +
# alpha_v, eta, int_fdr + ssw + nonlinear
BSDF_FIELD_BYTES = {"refl": 12, "spec": 12, "trans": 12, "cond": 24, "alpha": 8, "eta": 4,
                    "plast": 9}
BSDF_TYPE_FIELDS = {
    "eval": {1: ("refl",), 3: ("spec", "trans", "alpha", "eta"), 5: ("spec", "cond", "alpha"),
             6: ("refl", "eta", "plast"), 7: ("refl", "spec", "alpha", "eta", "plast")},
    "sample": {1: ("refl",), 2: ("spec", "trans", "eta"), 3: ("spec", "trans", "alpha", "eta"),
               4: ("spec", "cond"), 5: ("spec", "cond", "alpha"),
               6: ("refl", "spec", "eta", "plast"), 7: ("refl", "spec", "alpha", "eta", "plast")},
}
# a typed lane's other reads: wo and wi (eval); wo and the uniforms its type draws (sample)
BSDF_LANE_BYTES = {"eval": {t: 24 for t in (1, 3, 5, 6, 7)},
                   "sample": {1: 20, 2: 16, 3: 24, 4: 12, 5: 20, 6: 24, 7: 24}}
BSDF_OUT_BYTES = {"eval": 16, "sample": 32}  # f, pdf; and wi, lobe


def bsdf_lane_types(kind, b, mat_types):
    """Each lane's type as the kernel takes it (the wrapper's rule)."""
    import torch

    from pupiloptixlab_tpu_torch.render import bsdf

    force, mask = bsdf._lane_rule(kind, mat_types)
    if force:
        return torch.full_like(b.mtype, force), True
    m = b.mtype
    ok = (m >= 1) & (m <= 7) & (((mask >> m.clamp(0, 30)) & 1) == 1)
    return torch.where(ok, m, 0), False


def bsdf_call_bytes(kind, b, mat_types) -> tuple[int, dict]:
    """The bytes one K12 / K13 call reads and writes on these lanes: every
    lane's outputs and (unless one type is forced) its mtype, and each typed
    lane's planes as its type loads them; and the lanes of each type."""
    import torch

    typ, forced = bsdf_lane_types(kind, b, mat_types)
    n = typ.shape[0]
    counts = torch.bincount(typ.long(), minlength=8).tolist()
    total = n * (BSDF_OUT_BYTES[kind] + (0 if forced else 4))
    for t, fields in BSDF_TYPE_FIELDS[kind].items():
        total += counts[t] * (BSDF_LANE_BYTES[kind][t] + sum(BSDF_FIELD_BYTES[f] for f in fields))
    return total, {str(t): c for t, c in enumerate(counts) if c}


def capture_bsdf_calls(data, config, cam):
    """The arguments of every bsdf.evaluate and bsdf.sample call of one
    render_frame, in call order, and the frame's K12 / K13 launches."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.render import bsdf
    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    calls = []
    evaluate, sample = bsdf.evaluate, bsdf.sample

    def rec_eval(*a):
        calls.append(("eval", a))
        return evaluate(*a)

    def rec_sample(*a):
        calls.append(("sample", a))
        return sample(*a)

    accum = torch.zeros((config.width * config.height, 3), dtype=torch.float32, device=DEV)
    kernels.reset_launches()
    bsdf.evaluate, bsdf.sample = rec_eval, rec_sample
    try:
        render_frame(data, cam, 0, 0, accum, config)
    finally:
        bsdf.evaluate, bsdf.sample = evaluate, sample
    torch.cuda.synchronize()
    return calls, {k: kernels.LAUNCHES[k] for k in ("bsdf_eval", "bsdf_sample")}


def device_ops(fn) -> int:
    """Device operations one call of ``fn`` issues (torch.profiler, CUDA
    activity alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def main_bsdf(label: str) -> int:
    """``--bsdf``: K12 (bsdf_eval) and K13 (bsdf_sample) alone, on the
    arguments of every bsdf.evaluate / bsdf.sample call of one 1080p depth-4
    render_frame of oracle_mat and of mesh_env: each call bit-equal to the
    plain version on the card (every output, by bit pattern, NaN against NaN
    equal), timed (CUDA events around 20 calls, device and issue time apart),
    its byte bound at the HBM rate, the plain version's time and device
    operations; the frame's launches; the ptxas lines. Prints the card's
    line, then the results as one JSON line (also chiprun_out/bsdf_LABEL.json)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.render import bsdf
    from pupiloptixlab_tpu_torch.render.vec import Vec3

    log(f"[bsdf] {label}: package {Path(kernels.__file__).parent}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; {smi}")
    build(kernels)
    results: dict = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                     "label": label, "registers": ptxas_lines(kernels, "bsdf"), "scenes": {}}

    def flat(res):
        return [p for r in res for p in (r if isinstance(r, Vec3) else (r,))]

    def lanes_off(got, want) -> int:
        off = 0
        for g, w in zip(flat(got), flat(want)):
            if g.dtype == torch.float32:
                off += int(((g.view(torch.int32) != w.view(torch.int32))
                            & ~(g.isnan() & w.isnan())).sum())
            else:
                off += int((g != w).sum())
        return off

    with torch.inference_mode():
        for name, xml in (("oracle_mat", ORACLE_MAT), ("mesh_env", MESH_ENV)):
            data, config, cam = load_tables(xml, *FILM, DEV)
            calls, launches = capture_bsdf_calls(data, config, cam)
            require(launches == {"bsdf_eval": config.max_depth - 1,
                                 "bsdf_sample": config.max_depth - 1},
                    f"--bsdf {name}: one K12 and one K13 launch a bounce: {launches}")
            recs = []
            for kind, args in calls:
                kern = bsdf.evaluate if kind == "eval" else bsdf.sample
                plain = bsdf.evaluate_plain if kind == "eval" else bsdf.sample_plain
                off = lanes_off(kern(*args), plain(*args))
                require(off == 0, f"--bsdf {name} {kind}: {off} output lanes off the plain version")
                nbytes, types = bsdf_call_bytes(kind, args[0], args[-1])
                rec = {"kind": kind, "lanes": int(args[1].z.shape[0]), "lane_types": types,
                       "lanes_off": off, "bytes": nbytes,
                       "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "ms": cuda_time_ms(lambda: kern(*args), reps=20),
                       "plain_ms": cuda_time_ms(lambda: plain(*args), reps=3)}
                rec["device_ms"], rec["issue_ms"] = split_time_ms(lambda: kern(*args))
                rec["plain_issue_ms"] = host_time_ms(lambda: plain(*args))
                log(f"  {name} {kind}: {rec}")
                recs.append(rec)
            first = {kind: args for kind, args in reversed(calls)}
            ops = {kind: {"kernel": device_ops(lambda: (bsdf.evaluate if kind == "eval"
                                                        else bsdf.sample)(*args)),
                          "plain": device_ops(lambda: (bsdf.evaluate_plain if kind == "eval"
                                                       else bsdf.sample_plain)(*args))}
                   for kind, args in first.items()}
            log(f"  {name} device operations a call (first bounce): {ops}")
            results["scenes"][name] = {"mat_types": list(config.mat_types),
                                       "launches_per_frame": launches, "calls": recs,
                                       "device_ops_per_call": ops}
            del calls, data
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / f"bsdf_{label}.json").write_text(json.dumps(results, indent=1))
    print(smi)
    print(json.dumps(results))
    return 0


def cli() -> int:
    """No arguments: the whole smoke run. ``--tables LABEL [--package DIR]``:
    K3/K4 alone (main_tables); ``--inst LABEL [--package DIR]``: K7/K8 alone
    (main_inst); ``--bvh``: K1/K2/K11 alone (main_bvh); ``--sweep``: K5/K6
    alone (main_sweep); ``--mt``: K10 alone (main_mt); ``--atrous``: K9 alone
    (main_atrous); ``--display``: phase 22 alone (main_display); ``--batch``:
    phase 23 alone (main_batch); each with the package imported from DIR;
    ``--bsdf LABEL``: K12/K13 alone (main_bsdf)."""
    args = sys.argv[1:]
    if not args:
        return main()
    modes = {"--tables": main_tables, "--inst": main_inst, "--bvh": main_bvh,
             "--sweep": main_sweep, "--mt": main_mt, "--atrous": main_atrous,
             "--display": main_display, "--batch": main_batch, "--bsdf": main_bsdf}
    if args[0] not in modes or len(args) not in (2, 4) or (
            len(args) == 4 and args[2] != "--package"):
        print("usage: chip_smoke.py [--tables LABEL | --inst LABEL | --bvh LABEL | "
              "--sweep LABEL | --mt LABEL | --atrous LABEL | --display LABEL | "
              "--batch LABEL | --bsdf LABEL] "
              "[--package DIR]",
              file=sys.stderr)
        return 2
    root = Path(args[3]).resolve() if len(args) == 4 else REPO
    if not (root / "pupiloptixlab_tpu_torch").is_dir():
        print(f"chip_smoke.py: no pupiloptixlab_tpu_torch package in {root}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    return modes[args[0]](args[1])


if __name__ == "__main__":
    sys.exit(cli())
