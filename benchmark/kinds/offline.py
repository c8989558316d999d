"""``offline``: a closed loop of offline renders. Each image is one
``render(scene, camera, config, spp, seed0)`` of the port, its seed drawn
from the run's seed, ended by its (h, w, 3) radiance copied to the host.
Images start until the run's seconds have passed; the window ends when the
last image reaches the host.

The comparison, ``image_rel_mse``: the worst over the checked images (drawn
from the seed among the window's images) of sum((got - ref)^2) / sum(ref^2)
over the sampled pixels' accumulated radiance after all the image's
samples.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import check
from benchmark.harness.traffic import check_config, image_seeds, sample_pixels
from benchmark.reference import pixels as refpix


class Program:
    def __init__(self, cell, mix, seed, device, tracer):
        from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
        from pupiloptixlab_tpu_torch.render import integrator
        from pupiloptixlab_tpu_torch.scene import load_scene

        self.mix, self.device, self.tracer = mix, device, tracer
        self.integrator = integrator
        scene = load_scene(cell.root / cell.config["scene"])
        self.data, self.config = flatten_scene(scene, device=device)
        check_config(cell.config, self.config)
        self.camera = camera_block_from_scene(scene, device=device)
        self.seeds = image_seeds(seed, 100_000)
        self.pix = sample_pixels(seed, self.config.width, self.config.height,
                                 mix["check_pixels"], even=False)
        tracer.install()
        self._image(spp=mix["warmup_spp"], seed0=self.seeds[-1])

    def _image(self, spp, seed0):
        img = self.integrator.render(self.data, self.camera, self.config, spp=spp, seed0=seed0)
        return img.cpu()

    def _trace_calls(self) -> None:
        """The calls part: a render as the set-up's, whose eager warm-up
        sample makes every wrapper call a sample makes."""
        self.tracer.start("calls")
        self._image(spp=self.mix["warmup_spp"], seed0=self.seeds[-1])
        # the card renders one sample eagerly, the CPU every sample
        b = self.integrator.BATCH_STATS
        self.tracer.meta["calls_samples"] = 1 if "replays" in b else self.mix["warmup_spp"]
        self.tracer.stop()

    def window(self, seconds: float) -> dict:
        spp, traced_at = self.mix["spp"], self.mix["trace_image"]
        images, self.kept = [], []
        # a traced run profiles image ``traced_at``; the images before it
        # ran before any profiler started in the process ("clean": CUPTI
        # slows every later launch), which overhead_ms.offline and
        # device_idle.offline read
        phase = "clean"
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds or (self.tracer.enabled
                                                          and len(images) <= traced_at):
            k = len(images)
            traced = self.tracer.enabled and k == traced_at
            if traced:
                self._trace_calls()
                self.tracer.start("device")
            t0 = time.perf_counter()
            img = self._image(spp, self.seeds[k])
            t1 = time.perf_counter()
            if traced:
                b = self.integrator.BATCH_STATS
                # the replays and the eager warm-up sample (one eager loop on the CPU)
                self.tracer.meta["samples"] = b["replays"] + 1 if "replays" in b else spp
                self.tracer.stop()
            self.kept.append(img.reshape(-1, 3)[self.pix].numpy())
            images.append({"t0": t0 - t_start, "t1": t1 - t_start, "seed0": self.seeds[k],
                           "phase": "traced" if traced else phase,
                           "batch": dict(self.integrator.BATCH_STATS)})
            if traced:
                phase = "after"
        return {"kind": "offline", "spp": spp, "images": images, "attempted": len(images),
                "window_s": images[-1]["t1"], "samples": len(images) * spp}

    def outputs(self) -> dict:
        return {"pix": self.pix, "images": self.kept}

    def release(self) -> None:
        del self.data, self.camera


def numbers(cell, seed: int, out: dict, records: dict, device, control: bool = False) -> dict:
    ref = check.reference(cell, device)
    images, mix = records["images"], cell.traffic
    spp, worst = mix["spp"], 0.0
    for k in check.sample(seed, len(images), mix["check_images"]):
        seeds = [images[k]["seed0"] + i for i in range(spp)]
        want = refpix.accumulate(ref, out["pix"], seeds)["accum"]
        got = (refpix.accumulate(ref, out["pix"], seeds, lowp=True)["accum"]
               if control else out["images"][k])
        e = check.rel_mse(got, want)
        worst = max(worst, e) if np.isfinite(e) else float("inf")
    return {"image_rel_mse": worst}
