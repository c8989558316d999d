"""``interactive``: the viewer's closed loop. ``System`` + ``PTPass`` run
headless through ``System.run`` with a ``DisplayClient`` on
FRAME_FINISHED, whose pump ends each frame with its uint8 image on the
host; after every ``key_every``-th frame a camera step goes through
``DisplayClient.key``, a key drawn from the run's seed and then its
opposite, so that the view stays within one step of the scene's camera
(the accumulation restarts, and the client's stride-2 preview runs for its
hold time). Frames run until the run's seconds have passed.

The comparison: ``display_mad``, the mean absolute difference, in uint8
levels, of the displayed pixels of the checked frames (drawn from the seed,
and the last) from the reference's accumulation shown the same way;
``accum_rel_mse`` and ``aov_rel_mse``, the relative squared error of the
last frame's accumulation and of its albedo and normal together.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import check
from benchmark.harness.traffic import check_config, key_sequence, sample_pixels, sync
from benchmark.reference import pixels as refpix


class Program:
    def __init__(self, cell, mix, seed, device, tracer):
        from pupiloptixlab_tpu_torch.display.client import DisplayClient
        from pupiloptixlab_tpu_torch.passes import PTPass
        from pupiloptixlab_tpu_torch.system import System
        from pupiloptixlab_tpu_torch.utils.event import FRAME_FINISHED

        self.mix, self.device, self.tracer = mix, device, tracer
        self.system = System(device=device)
        self.system.events.bind(FRAME_FINISHED, self._before_pump)
        self.client = DisplayClient(self.system)
        self.system.events.bind(FRAME_FINISHED, self._after_pump)
        self.pt = PTPass()
        self.system.add_pass(self.pt)
        scene_path = cell.root / cell.config["scene"]
        if not self.system.set_scene(scene_path):
            raise RuntimeError(f"the system could not load {scene_path}")
        _, self.config = self.system.world.get_scene_data()
        check_config(cell.config, self.config)
        w, h = self.config.width, self.config.height
        self.pix = sample_pixels(seed, w, h, mix["check_pixels"], even=True)
        x, y = self.pix % w, self.pix // w
        # where each sampled film pixel lands in the displayed image (row 0 at
        # the top, the film's row 0 at the bottom), at stride 1 and 2
        self.at = {1: (h - 1 - y, x), 2: ((h + 1) // 2 - 1 - y // 2, x // 2)}
        self.keys = key_sequence(seed, 200_000)
        self.frames, self.key_log = [], []  # key_log: (frame after which it was sent, key)
        self.frame = 0          # frames finished so far, warm-up included
        # a traced run's frames: ``clean_frames`` before any profiler started
        # in the process (CUPTI slows every later launch), which
        # device_idle.interactive reads; ``pump_frames`` with a synchronise
        # before the pump, which pump_ms.interactive reads; the calls part;
        # the device part; then frames until the run's seconds have passed
        self.pump_at = mix["clean_frames"]
        self.calls_at = self.pump_at + mix["pump_frames"]
        self.device_at = self.calls_at + mix["trace_calls"]
        self.end_at = self.device_at + mix["trace_device"]
        self.timed = False
        self.pump_t0 = None
        tracer.install()
        # warm-up: a step, its return and a steady frame (both strides shown)
        self._warm_keys = {0: self.keys[0], 1: self.keys[1]}
        self.system.run(max_frames=mix["warmup_frames"])
        self.next_key = 2

    def _send(self, key: str) -> None:
        self.client.key(key)
        self.key_log.append((self.frame, key))

    def _phase(self, i: int) -> str:
        """What frame ``i`` of the window ran under (the frame after the
        device part holds its stop)."""
        if not self.tracer.enabled or i < self.pump_at:
            return "clean"
        if i < self.calls_at:
            return "pump"
        return "traced" if i <= self.end_at else "after"

    def _before_pump(self, _ms) -> None:
        # the pump frames time the pump from a synchronise (which the other
        # frames do not make)
        if self.timed and self._phase(len(self.frames)) == "pump":
            sync(self.device)
            self.pump_t0 = time.perf_counter()

    def _after_pump(self, _ms) -> None:
        t = time.perf_counter()
        img = self.client.latest_image()
        stride = 1 if img.shape[0] == self.config.height else 2
        r, c = self.at[stride]
        if self.timed:
            self.frames.append({"t": t - self.t_start, "stride": stride,
                                "pump_s": None if self.pump_t0 is None else t - self.pump_t0,
                                "phase": self._phase(len(self.frames)),
                                "shown": img[r, c].copy(), "frame": self.frame})
            self.pump_t0 = None
            j = len(self.frames)
            if self.tracer.enabled:
                if j == self.calls_at:
                    self.tracer.start("calls")
                elif j == self.device_at:
                    self.tracer.stop()
                    self.tracer.meta["calls_frames"] = self.mix["trace_calls"]
                    self.tracer.start("device")
                elif j == self.end_at:
                    self.tracer.stop()
                    self.tracer.meta["frames"] = self.mix["trace_device"]
            if j % self.mix["key_every"] == 0:
                self._send(self.keys[self.next_key])
                self.next_key += 1
            if t - self.t_start >= self.seconds and (not self.tracer.enabled or j > self.end_at):
                self.system.quit()
        elif self.frame in self._warm_keys:
            self._send(self._warm_keys[self.frame])
        self.frame += 1

    def window(self, seconds: float) -> dict:
        self.seconds = seconds
        self.timed = True
        self.t_start = time.perf_counter()
        self.system.run()
        fr = self.frames
        durations = [fr[0]["t"]] + [b["t"] - a["t"] for a, b in zip(fr, fr[1:])]
        for f, d in zip(fr, durations):
            f["ms"] = d * 1e3
        return {"kind": "interactive", "frames": fr, "attempted": len(fr),
                "window_s": fr[-1]["t"], "warmup_frames": self.mix["warmup_frames"],
                "keys": self.key_log}

    def outputs(self) -> dict:
        """What the check compares: every window frame's displayed pixels,
        and the last frame's accumulation, albedo and normal at the pixels."""
        bm = self.system.buffers
        idx = torch.as_tensor(self.pix, device=self.device)
        last = {name: bm[buf].array[idx].cpu().numpy() for name, buf in
                (("accum", "pt accum"), ("albedo", "pt albedo"), ("normal", "pt normal"))}
        return {"pix": self.pix, "frames": self.frames, "keys": self.key_log,
                "last": last, "last_frame": self.frame - 1}

    def release(self) -> None:
        self.system.destroy()
        del self.system, self.client, self.pt


def _frame_state(keys, g: int):
    """The camera's key steps and the accumulation's first frame at frame
    ``g``: a step sent after frame f restarts the accumulation at f + 1."""
    sent = [(f, k) for f, k in keys if f < g]
    return [k for _, k in sent], (sent[-1][0] + 1 if sent else 0)


def numbers(cell, seed: int, out: dict, records: dict, device, control: bool = False) -> dict:
    ref = check.reference(cell, device)
    frames, keys, dev = out["frames"], out["keys"], ref.device
    picked = check.sample(seed, len(frames) - 1, cell.traffic["check_frames"]) + [len(frames) - 1]
    by_start: dict = {}
    for j in picked:
        g = frames[j]["frame"]
        steps, start = _frame_state(keys, g)
        by_start.setdefault((start, tuple(steps)), []).append((j, g))
    levels, count = 0.0, 0
    last = {}
    for (start, steps), items in by_start.items():
        g_hi = max(g for _, g in items)
        seeds = list(range(start, g_hi + 1))   # PTPass traces frame g at seed g
        keep = {g - start + 1 for _, g in items}
        want = refpix.accumulate(ref, out["pix"], seeds, steps, keep=keep)
        lowp = refpix.accumulate(ref, out["pix"], seeds, steps, lowp=True, keep=keep) \
            if control else None
        for j, g in items:
            n = g - start + 1
            shown_ref = refpix.display_u8(want["kept"][n], dev).astype(np.int64)
            shown = (refpix.display_u8(lowp["kept"][n], dev) if control
                     else frames[j]["shown"]).astype(np.int64)
            levels += float(np.abs(shown - shown_ref).sum())
            count += shown_ref.size
            if g == out["last_frame"]:
                last = {"want": want, "got": lowp if control else out["last"]}
    if not last:
        raise RuntimeError("the last frame was not among the checked frames")
    w, got = last["want"], last["got"]
    return {
        "display_mad": levels / count,
        "accum_rel_mse": check.rel_mse(got["accum"], w["accum"]),
        "aov_rel_mse": check.rel_mse(np.concatenate([got["albedo"], got["normal"]]),
                                     np.concatenate([w["albedo"], w["normal"]])),
    }
