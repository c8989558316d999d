"""``restir``: the viewer's closed loop with ReSTIR DI in place of the path
tracer. ``System`` + ``ReSTIRPass`` (the mix's M, spatial taps and radius;
the frame function's own temporal cap) run headless through
``System.run`` with a ``DisplayClient`` on FRAME_FINISHED, whose pump ends
each frame with its uint8 image on the host; after every ``key_every``-th
frame a camera step goes through ``DisplayClient.key``, a key drawn from
the run's seed and then its opposite, as ``interactive`` does. Each step
resets the pass's reservoir history and its accumulation. Frames run until
the run's seconds have passed. The window's record is ``interactive``'s
(its ``kind``, ``frames`` with their ``phase`` and ``pump_s``, and
``window_s``), so that the interactive metrics read it.

A traced run makes, as ``interactive`` does, ``clean_frames`` frames before
any profiler starts (which ``device_idle.interactive`` reads) and
``pump_frames`` with a synchronise before the pump (``pump_ms.interactive``);
then ``stats_frames`` with the program's ``RESTIR_STATS`` switched on (the
stages' ms on the stream's clock, which ``candidates_ms.restir`` and
``reuse_ms.restir`` read; a program without it gives nothing to read), then
the tracer's calls part (``trace_calls`` frames) and device part
(``trace_device`` frames).

The comparison (``benchmark/reference/render/restir.py`` works out a frame
at the checked pixels, drawn from the seed, from the frame's input rows: the
previous frame's output rows, or zeros on the first frame after a reset,
which the pass's contract makes them):

- ``frame_rel_mse``: the worst over the checked frames (drawn from the seed
  before the window among its first ``check_span``, and the last) of the
  relative squared error of the frame's radiance at the checked pixels;
- ``winner_mismatch``: the share of the checked frames' checked pixels with
  a primary hit whose winning light position (row columns 0-2) differs
  from the reference's (a pixel without a hit has no reservoir that any
  merge or its shading reads);
- ``accum_rel_mse``: the last frame's accumulation at the checked pixels
  against the reference's blend of its own frames since the last reset.

A frame's random draws are keyed by its seed and the pixel alone, so the
pixels each checked pixel's spatial taps read are known before the frame
runs: before the window, the lanes of every frame of the run (its seed
counted from the pass's) are worked out on the device for ``lane_frames``
frames (further frames' at their end). At each frame's end one gather keeps
its output rows at the checked pixels and at the next frame's lanes (that
frame's input), and one its radiance at the checked pixels; the check puts
the kept input rows back in a film of NaN, so that a row read outside the
lanes spoils the comparison.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check
from benchmark.harness.traffic import check_config, key_sequence, rng_of, sample_pixels, sync
from benchmark.reference.flatten.flatten import camera_block
from benchmark.reference.render import restir as refrestir


def checked_frames(seed: int, span: int, count: int) -> set:
    """The window frames checked besides the last: ``count`` of the first
    ``span``, drawn from the seed before the window."""
    return {int(i) for i in rng_of(seed, 5).choice(span, size=min(count, span), replace=False)}


def frame_lanes(pix: torch.Tensor, seeds: torch.Tensor, config, mix) -> torch.Tensor:
    """(frames, (1 + taps) P): the checked pixels ``pix`` and the pixels
    their spatial taps read, for each frame seed of ``seeds`` (worked out
    64 frames at a time)."""
    p, out = pix.shape[0], []
    for part in seeds.split(64):
        f = part.shape[0]
        taps = refrestir._tap_ids(pix.repeat(f), part.repeat_interleave(p), config,
                                  mix["m_candidates"], mix["spatial_taps"],
                                  mix["spatial_radius"])
        ids = torch.stack([pix.repeat(f)] + [t for t, _ in taps])   # (1 + taps, f P)
        out.append(ids.reshape(-1, f, p).transpose(0, 1).reshape(f, -1))
    return torch.cat(out)


class Program:
    def __init__(self, cell, mix, seed, device, tracer):
        from pupiloptixlab_tpu_torch.display.client import DisplayClient
        from pupiloptixlab_tpu_torch.passes import ReSTIRPass
        from pupiloptixlab_tpu_torch.render import restir as restir_mod
        from pupiloptixlab_tpu_torch.system import System
        from pupiloptixlab_tpu_torch.utils.event import FRAME_FINISHED

        self.mix, self.device, self.tracer = mix, device, tracer
        # the program's stage clock, where it has one
        self.stats = getattr(restir_mod, "RESTIR_STATS", None)
        self.system = System(device=device)
        self.system.events.bind(FRAME_FINISHED, self._before_pump)
        self.client = DisplayClient(self.system)
        self.system.events.bind(FRAME_FINISHED, self._after_pump)
        self.rp = ReSTIRPass(m_candidates=mix["m_candidates"], spatial_taps=mix["spatial_taps"],
                             spatial_radius=mix["spatial_radius"])
        self.system.add_pass(self.rp)
        scene_path = cell.root / cell.config["scene"]
        if not self.system.set_scene(scene_path):
            raise RuntimeError(f"the system could not load {scene_path}")
        _, self.config = self.system.world.get_scene_data()
        check_config(cell.config, self.config)
        w, h = self.config.width, self.config.height
        self.pix = sample_pixels(seed, w, h, mix["check_pixels"], even=False)
        self.idx = torch.as_tensor(self.pix, device=device)
        # the gather index of frame seed s (from seed0): the checked pixels,
        # then frame s + 1's lanes
        self.seed0 = self.rp.seed
        seeds = torch.arange(self.seed0 + 1, self.seed0 + 1 + mix["lane_frames"], device=device)
        self.kept_at = torch.cat([self.idx.expand(seeds.shape[0], -1),
                                  frame_lanes(self.idx, seeds, self.config, mix)], dim=1)
        self.check_at = checked_frames(seed, mix["check_span"], mix["check_frames"])
        self.keys = key_sequence(seed, 200_000)
        self.frames, self.key_log = [], []   # key_log: (frame after which it was sent, key)
        self.frame = 0                       # frames finished so far, warm-up included
        self.checked, self.segment = [], []  # kept frames; the frames since the last reset
        self.next_inp = None                 # the next frame's input rows at its lanes
        self.stage_ms = []                   # RESTIR_STATS of the stats frames
        self.pump_at = mix["clean_frames"]
        self.stats_at = self.pump_at + mix["pump_frames"]
        self.calls_at = self.stats_at + mix["stats_frames"]
        self.device_at = self.calls_at + mix["trace_calls"]
        self.end_at = self.device_at + mix["trace_device"]
        self.timed = False
        self.pump_t0 = None
        tracer.install()
        # warm-up: a step, its return and a steady frame
        self._warm_keys = {0: self.keys[0], 1: self.keys[1]}
        self.system.run(max_frames=mix["warmup_frames"])
        self.next_key = 2

    def _send(self, key: str) -> None:
        self.client.key(key)
        self.key_log.append((self.frame, key))

    def _phase(self, i: int) -> str:
        """What window frame ``i`` ran under (the frame after the device
        part holds its stop)."""
        if not self.tracer.enabled or i < self.pump_at:
            return "clean"
        if i < self.stats_at:
            return "pump"
        if i < self.calls_at:
            return "stats"
        return "traced" if i <= self.end_at else "after"

    def _kept_index(self, s: int) -> torch.Tensor:
        i = s - self.seed0
        if i < self.kept_at.shape[0]:
            return self.kept_at[i]
        nxt = torch.tensor([s + 1], device=self.device)
        return torch.cat([self.idx, frame_lanes(self.idx, nxt, self.config, self.mix)[0]])

    def _keep(self, j) -> None:
        """The frame's input rows at its lanes (None: zeros), its output
        rows and radiance at the checked pixels, and its output rows at the
        next frame's lanes."""
        rp, p = self.rp, self.idx.shape[0]
        s = rp.seed - 1
        at = self._kept_index(s)
        rows = rp._reservoirs[at]
        rec = {"g": self.frame, "seed": s, "cnt": rp.sample_cnt,
               "inp": None if rp.sample_cnt == 1 else self.next_inp,
               "out": rows[:p], "rad": self.system.buffers["restir frame"].array[self.idx]}
        self.next_inp = (at[p:], rows[p:])
        self.segment = [rec] if rec["cnt"] == 1 else self.segment + [rec]
        if j is not None and j in self.check_at:
            self.checked.append(rec)

    def _stats(self, on: bool) -> None:
        if self.stats is not None:
            self.stats["enabled"] = on

    def _before_pump(self, _ms) -> None:
        # the pump frames time the pump from a synchronise (which the other
        # frames do not make)
        if self.timed and self._phase(len(self.frames)) == "pump":
            sync(self.device)
            self.pump_t0 = time.perf_counter()

    def _after_pump(self, _ms) -> None:
        t = time.perf_counter()
        if not self.timed:
            self._keep(None)
            if self.frame in self._warm_keys:
                self._send(self._warm_keys[self.frame])
            self.frame += 1
            return
        j = len(self.frames)
        phase = self._phase(j)
        if phase == "stats" and self.stats is not None:
            self.stage_ms.append(dict(self.stats.get("stage_ms", {})))
        self.frames.append({"t": t - self.t_start, "phase": phase, "frame": self.frame,
                            "pump_s": None if self.pump_t0 is None else t - self.pump_t0})
        self.pump_t0 = None
        self._keep(j)
        j += 1
        if self.tracer.enabled:
            self._stats(self.stats_at <= j < self.calls_at)
            if j == self.calls_at:
                self.tracer.start("calls")
            elif j == self.device_at:
                self.tracer.stop()
                self.tracer.meta["calls_samples"] = self.mix["trace_calls"]
                self.tracer.start("device")
            elif j == self.end_at:
                self.tracer.stop()
                self.tracer.meta.update(frames=self.mix["trace_device"],
                                        samples=self.mix["trace_device"])
        if j % self.mix["key_every"] == 0:
            self._send(self.keys[self.next_key])
            self.next_key += 1
        if t - self.t_start >= self.seconds and (not self.tracer.enabled or j > self.end_at):
            self.system.quit()
        self.frame += 1

    def window(self, seconds: float) -> dict:
        self.seconds = seconds
        self.timed = True
        self.t_start = time.perf_counter()
        self.system.run()
        self._stats(False)
        fr = self.frames
        durations = [fr[0]["t"]] + [b["t"] - a["t"] for a, b in zip(fr, fr[1:])]
        for f, d in zip(fr, durations):
            f["ms"] = d * 1e3
        return {"kind": "interactive", "frames": fr, "attempted": len(fr),
                "window_s": fr[-1]["t"], "warmup_frames": self.mix["warmup_frames"],
                "keys": self.key_log, "restir_stage_ms": self.stage_ms}

    def outputs(self) -> dict:
        last = self.segment[-1]
        if not self.checked or self.checked[-1] is not last:
            self.checked.append(last)
        return {"pix": self.pix, "checked": self.checked, "segment": self.segment,
                "keys": self.key_log,
                "last_accum": self.rp._accum[self.idx].cpu().numpy()}

    def release(self) -> None:
        self.system.destroy()
        del self.system, self.client, self.rp


def numbers(cell, seed: int, out: dict, records: dict, device, control: bool = False) -> dict:
    ref = check.reference(cell, device)
    mix = cell.traffic
    dev = ref.device
    frames: dict = {}

    def frame(rec, lowp: bool) -> dict:
        """The reference's frame ``rec`` at the checked pixels, from its
        input rows put back in a film of NaN."""
        key = (rec["g"], lowp)
        if key not in frames:
            steps = [k for f, k in out["keys"] if f < rec["g"]]
            inp = None
            if rec["inp"] is not None:
                at, rows = (x.to(dev) for x in rec["inp"])
                n = ref.config.width * ref.config.height
                inp = torch.full((n, rows.shape[1]), float("nan"), device=dev)
                inp[at] = rows
            frames[key] = refrestir.restir_pixels(
                ref.data, ref.config, camera_block(ref.camera(steps), dev), rec["seed"],
                inp, out["pix"], mix["m_candidates"], mix["spatial_taps"],
                mix["spatial_radius"], lowp=lowp)
        return frames[key]

    worst, differ, hits = 0.0, 0, 0
    for rec in out["checked"]:
        want = frame(rec, False)
        if control:
            got = frame(rec, True)
            got_rad, got_rows = got["radiance"], got["rows"]
        else:
            got_rad, got_rows = rec["rad"].to(dev), rec["out"].to(dev)
        e = check.rel_mse(got_rad.cpu().numpy(), want["radiance"].cpu().numpy())
        worst = max(worst, e) if np.isfinite(e) else float("inf")
        hit = want["hit"]
        differ += int(((got_rows[:, :3] != want["rows"][:, :3]).any(1) & hit).sum())
        hits += int(hit.sum())
    seg = out["segment"]
    want_acc = refrestir.blend_frames([frame(r, False)["radiance"] for r in seg])
    got_acc = (refrestir.blend_frames([frame(r, True)["radiance"] for r in seg], lowp=True)
               .cpu().numpy() if control else out["last_accum"])
    return {"frame_rel_mse": worst,
            "winner_mismatch": differ / hits if hits else 0.0,
            "accum_rel_mse": check.rel_mse(got_acc, want_acc.cpu().numpy())}
