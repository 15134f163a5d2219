"""Closed-loop serving, one client: each request is a batch of slices
through ``pipeline.make_hoisted_sampler`` (the tower once, the DDIM steps
of the UNet at the trunk precision, the output copied to the host),
dispatched as soon as the previous one returned.  The configuration's
``precision`` block states the trunk's compute dtype (``serve_trunk``) and
the tower's (``tower``); the program serves at them, and the control runs
the reference at the next precision below each.

Traffic parameters: ``batch`` slices a request, ``pool`` distinct batches
(with their initial noise) that the requests cycle, ``warmup`` requests in
set-up, ``check_requests`` requests compared with the reference after the
window, ``trace_units`` requests in each traced phase.
"""

from __future__ import annotations

import statistics

import torch

from bench_h100.lib import build, compare, data
from bench_h100.reference import diffusion as RD
from bench_h100.reference import precision as P


class Cell:
    trains = False

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.precision = config["precision"]["serve_trunk"]
        self.tower_precision = config["precision"]["tower"]

    def setup(self):
        from founddiff_tpu_torch.pipeline import make_hoisted_sampler

        t, dev = self.traffic, self.device
        clock = build.Clock(dev)
        size = self.config["program"]["diffusion"]["image_size"]
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        _, ld = data.ct_pairs(t["batch"] * t["pool"], size, gen, dev)
        self.inputs = ld.reshape(t["pool"], t["batch"], size, size, 1)
        self.noise = torch.randn(self.inputs.shape, generator=gen, device=dev)
        st = build.state(self.config, self.seed, dev, self.inputs[0])
        self.state = build.to_host(st)
        clock.lap("inputs_weights")
        _, self.diffusion, self.model = build.program(self.config, dev, train=False)
        self.model.load_state_dict(st)
        del st
        clock.lap("program")
        for part in ("tower", "schedule"):
            if self.config["precision"][part] != "float32":
                raise ValueError(f"{self.config['name']}: the program's sampler runs its {part} "
                                 f"in float32, not {self.config['precision'][part]}")
        self.sample = make_hoisted_sampler(self.model, self.diffusion,
                                           compute_dtype=getattr(torch, self.precision))
        self.outputs, self.embeddings, self._embedded = [], [], None
        encode = self.model.encode

        def recorded(x):  # keeps the tower's embeddings of each request for the check
            self._embedded = encode(x)
            return self._embedded
        self.model.encode = recorded
        for i in range(t["warmup"]):
            self._request(i)
        clock.lap("warmup")
        self.timings = clock.laps

    def _request(self, i: int):
        k = i % self.traffic["pool"]
        return self.sample(self.inputs[k], noise=self.noise[k]).cpu()

    def run_once(self, i: int) -> int:
        out = self._request(i)
        self.outputs.append(out)
        self.embeddings.append(self._embedded)
        return out.shape[0]

    def failures(self, n: int) -> int:
        """Requests of the window whose slices are not all finite."""
        return sum(not bool(torch.isfinite(o).all()) for o in self.outputs[:n])

    def end_to_end(self, records, window_s: float) -> dict:
        lat = [r[0] for r in records]
        p95 = statistics.quantiles(lat, n=20)[18] if len(lat) > 1 else lat[0]
        return {"slices_per_s": sum(r[1] for r in records) / window_s,
                "request_p95_ms": p95 * 1e3}

    def release(self):
        del self.sample, self.model, self.diffusion
        build.free(self.device)

    def _reference(self, i, ref, trunk="fp32", tower="fp32"):
        d = self.config["program"]["diffusion"]
        k = i % self.traffic["pool"]
        return RD.serve(ref, self.inputs[k], self.noise[k], steps=d["sampling_timesteps"],
                        T=d["timesteps"], sum_scale=d["sum_scale"], trunk=trunk, tower=tower)

    def check(self, rng, control: bool = False) -> dict:
        """The worst numbers over a seeded sample of the finished requests:
        the denoised slices and the tower's embeddings against the
        reference's.  ``control``: the reference with the trunk's and the
        tower's products at the next precision below the stated ones stands
        in for the program (the control run, which has to fail)."""
        ref = build.reference(self.config, self.device)
        ref.load_state_dict(self.state)
        ref.eval()
        pick = rng.sample(range(len(self.outputs)),
                          min(self.traffic["check_requests"], len(self.outputs)))
        numbers = []
        for i in pick:
            want, want_emb = self._reference(i, ref)
            if control:
                got, got_emb = self._reference(i, ref, P.below(self.precision),
                                               P.below(self.tower_precision))
            else:
                got, got_emb = self.outputs[i], self.embeddings[i]
            numbers.append(compare.serve_numbers(got, want, got_emb, want_emb))
        return compare.worst(numbers)
