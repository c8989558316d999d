"""The ``restir`` kind (``meshlight_env.restir_di``) run whole on the CPU at
32x18 with every pixel checked: the program comes out correct, and the
control and three planted faults come out not correct: a spatial tap's merge
skipped, the temporal cap left out, and the winner's shadow ray not traced.
With 24 pixels checked the rows the check keeps (at those pixels and the
pixels their taps read) suffice.

At 32x18 a tap within the cell's 30 pixels lands anywhere on the film, where
few neighbours pass the similarity gate, so the mix here taps within 2
pixels; and it warms up over two more frames after its last camera step,
so that the window's first frame merges a history past the temporal cap."""

import json
import time

import pytest

from benchmark.harness import spec
from benchmark.harness.runner import run_cell
from conftest import make_root

CELL = "meshlight_env.restir_di"
FILM = (32, 18)


def make_cell_root(tmp_path, check_pixels=FILM[0] * FILM[1], **mix_keys):
    root = make_root(tmp_path, film=FILM, check_pixels=check_pixels)
    mix = root / "benchmark" / "traffic" / "restir_di.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "warmup_frames": 5,
                               "spatial_radius": 2, **mix_keys}))
    return root


@pytest.fixture
def root(tmp_path):
    return make_cell_root(tmp_path)


def run(root, control=False):
    return run_cell(spec.load_cell(CELL, root), 2**33 + 5, 0.5, False, "cpu",
                    time.perf_counter(), control=control)


def test_the_program_is_correct_and_the_control_is_not(root):
    r = run(root, control=True)
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]
    assert r["attempted"] >= 1 and set(r["metrics"]) == {"frame_ms", "setup_s"}
    limits = spec.load_cell(CELL, root).limits
    assert all(v > limits[k] for k, v in r["control"].items()), r["control"]


@pytest.mark.parametrize("lane_frames", [1000, 2])
def test_rows_kept_at_a_few_pixels_and_their_taps_suffice(tmp_path, lane_frames):
    """24 checked pixels, so that the kept input rows cover a part of the
    film (a row read outside them is NaN); the lanes worked out before the
    window for every frame, or for 2 frames only, so that the later frames'
    are worked out at their end."""
    r = run(make_cell_root(tmp_path, check_pixels=24, lane_frames=lane_frames))
    assert r["correct"] is True, r["checks"]
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]


def _skip_a_tap(monkeypatch, taps):
    from pupiloptixlab_tpu_torch.render import restir

    real, calls = restir.merge, [0]

    def merge(r, other, *args, **kwargs):
        # merges come 1 (temporal) + taps a frame; the last tap's is skipped
        calls[0] += 1
        return r if calls[0] % (1 + taps) == 0 else real(r, other, *args, **kwargs)

    monkeypatch.setattr(restir, "merge", merge)


def _no_cap(monkeypatch, taps):
    from pupiloptixlab_tpu_torch.passes import restir as pass_mod

    real = pass_mod.restir_frame

    def restir_frame(*args, **kwargs):
        return real(*args, **kwargs, m_cap=float("inf"))

    monkeypatch.setattr(pass_mod, "restir_frame", restir_frame)


def _unshadowed(monkeypatch, taps):
    from pupiloptixlab_tpu_torch.render import restir
    from pupiloptixlab_tpu_torch.render.vec import Vec3, where

    def shade(scene, config, r, gb, local, hit_mask, clock=None):
        phat, contrib, _, _ = restir._eval_target(gb, local, config.mat_types, r.y_pos,
                                                  r.y_nrm, r.y_rad)
        live = hit_mask & (r.w_sum > 0.0) & (phat > restir._TINY)
        return where(live, contrib * r.ucw, Vec3.zeros(r.w_sum.shape[0]))

    monkeypatch.setattr(restir, "shade", shade)


@pytest.mark.parametrize("fault", [_skip_a_tap, _no_cap, _unshadowed])
def test_a_broken_reservoir_path_comes_out_not_correct(root, monkeypatch, fault):
    fault(monkeypatch, spec.load_cell(CELL, root).traffic["spatial_taps"])
    r = run(root)
    assert r["correct"] is False, r["checks"]
