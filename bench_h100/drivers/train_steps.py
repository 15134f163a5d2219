"""Training steps back to back: ``Trainer.train_step`` on batches from a pool
on the device (microbatches, the clip, Adam, the EMA, as ``TrainConfig``).

Set-up builds the one trainer the window uses and drives it through its
first ``check_steps`` steps, on distinct rows, through the same call; what
they produced (the losses, the first clipped gradient as Adam holds it,
the parameters and the EMA after them) is what the reference is held to
after the window.

A step takes the configuration's ``train_batch_size`` slices in each of its
``gradient_accumulate_every`` microbatches.  Traffic parameters: ``pool``
distinct step batches, ``check_steps``, ``trace_units`` steps in each
traced phase.
"""

from __future__ import annotations

import math

import torch

from bench_h100.lib import build, compare, data
from bench_h100.reference import diffusion as RD
from bench_h100.reference import precision as P

LOSS = {"founddiff": "residual", "vanilla": "gaussian"}


class Cell:
    trains = True

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.precision = config["precision"]["train"]

    def setup(self):
        from founddiff_tpu_torch.train.trainer import Trainer

        t, dev = self.traffic, self.device
        clock = build.Clock(dev)
        size = self.config["program"]["diffusion"]["image_size"]
        tc = self.config["program"]["train"]
        step = tc["train_batch_size"] * tc["gradient_accumulate_every"]
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        gt, ld = data.ct_pairs(step * t["pool"], size, gen, dev)
        shape = (t["pool"], step, size, size, 1)
        self.pool = list(zip(gt.reshape(shape), ld.reshape(shape)))
        st = build.state(self.config, self.seed, dev, self.pool[0][1])
        self.state = build.to_host(st)
        clock.lap("inputs_weights")
        self.cfg, diffusion, model = build.program(self.config, dev, train=True, seed=self.seed)
        model.load_state_dict(st)
        del st
        self.model = model
        self.trainer = Trainer(diffusion, model, self.cfg)
        clock.lap("program")
        self.names = [n for n, p in model.named_parameters() if p.requires_grad]
        params = dict(model.named_parameters())
        beta1 = self.cfg.train.adam_betas[0]
        losses = []
        for s in range(t["check_steps"]):
            losses.append(self.trainer.train_step(self.pool[s])[0])
            if s == 0:
                opt = self.trainer.opt.state
                grad1 = {n: (opt[params[n]]["exp_avg"] / (1 - beta1)).cpu() for n in self.names}
        ema = dict(self.trainer.ema.named_parameters())
        host = lambda t: t.detach().to("cpu", copy=True)
        self.program_out = dict(losses=losses, grad1=grad1,
                                params={n: host(params[n]) for n in self.names},
                                ema={n: host(ema[n]) for n in self.names})
        clock.lap("first_steps")
        self.timings = clock.laps
        self.losses = []

    def run_once(self, i: int) -> int:
        batch = self.pool[(self.traffic["check_steps"] + i) % self.traffic["pool"]]
        self.losses.append(self.trainer.train_step(batch))
        return batch[0].shape[0]

    def failures(self, n: int) -> int:
        """Steps of the window with a loss that is not finite."""
        return sum(not all(math.isfinite(v) for v in losses) for losses in self.losses[:n])

    def end_to_end(self, records, window_s: float) -> dict:
        return {"train_slices_per_s": sum(r[1] for r in records) / window_s}

    def release(self):
        del self.trainer, self.model
        build.free(self.device)

    def _reference(self, products: str) -> dict:
        ref = build.reference(self.config, self.device)
        ref.load_state_dict(self.state)
        for n, p in ref.named_parameters():
            p.requires_grad_(n in self.names)
        tc = self.cfg.train
        out = RD.train_steps(ref, self.names, self.pool[:self.traffic["check_steps"]], self.seed,
                             LOSS[self.config["family"]], tc.gradient_accumulate_every,
                             tc.train_lr, tc.adam_betas, tc.max_grad_norm, products=products)
        params = dict(ref.named_parameters())
        out["params"] = {n: params[n].detach() for n in self.names}
        out["ema"] = {n: out["ema"][n] for n in self.names}
        return out

    def check(self, rng, control: bool = False) -> dict:
        """The numbers of the first steps against the reference's.
        ``control``: the reference with its products at the next precision
        below the stated one stands in for the program (the control run,
        which has to fail)."""
        ref = self._reference("fp32")
        prog = self._reference(P.below(self.precision)) if control else self.program_out
        dev = lambda d: {n: v.to(self.device) for n, v in d.items()}
        prog = dict(prog, grad1=dev(prog["grad1"]), params=dev(prog["params"]),
                    ema=dev(prog["ema"]))
        start = {n: self.state[n].to(self.device) for n in self.names}
        numbers, self.details = compare.train_numbers(prog, ref, start)
        return numbers
