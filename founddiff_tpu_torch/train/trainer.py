"""Trainer: the train step, the training loop, checkpoints and sampling
(mirror of ``founddiff_tpu/train/trainer.py``; reference
src/DADiff.py:1506-1971).

One step (``Trainer._step_fn``, trainer.py:132-214): the batch splits into
``gradient_accumulate_every`` microbatches; each adds the gradient of its
``sum(losses) / accum``; then optax's global-norm clip, Adam (RAdam for two
UNets), the EMA update, step += 1.  ``mixed_precision="bf16"`` runs the
model on bf16 copies of every fp32 tensor the JAX step casts (trainer.py:
141-184): every parameter, the frozen Dose-CLIP tower's too, and the
buffers the JAX tree holds as parameters (BatchNorm statistics, prompt
token embeddings); gradients reach the fp32 masters through the cast.  The
inputs are cast to bf16 and the predictions back to fp32 for the loss.
The conditional (FoundDiff) and the generation (vanilla DDPM) paths both
train here; ``sample()`` follows the JAX ``Trainer.sample`` routes.

With ``train_dataset`` the loop draws ``(gt, ld)`` batches from
``cycle(Loader(...))`` when none are passed, writes ``metrics.jsonl`` and,
with ``sample_dataset``, the preview ``sample-<milestone>.png`` at every
``save_and_sample_every`` steps and the periodic ``test(fid=fid_eval)``.
``test()`` is the evaluation protocol of the JAX ``Trainer.test``
(trainer.py:419-519): every slice of ``sample_dataset`` denoised with the
EMA weights on the test schedule, PSNR/SSIM/RMSE on the card, per-anatomy
and per-dose log lines, the ``.npy`` predictions and a Dose-CLIP FID.

Random draws (timesteps, noise) come from one ``torch.Generator`` seeded
with ``train.seed``, on the CPU, so a seed gives the same run on every
device.

Data parallelism (``mesh=``, ``founddiff_tpu/train/trainer.py:60-88,
236-245``): every rank reads the same loader and draws the same timesteps
and noise, at the global microbatch's shape, and takes its rows of each
(``shard_batch``), so a step over ``data`` ranks makes the update of one
process on the global batch.  After the microbatches one flat
``all_reduce`` over the data group averages the gradients (and the
losses), before the clip, as XLA's all-reduce precedes it in the JAX step.
The parameters, buffers and EMA are broadcast from rank 0 at the start.
Only rank 0 writes checkpoints, previews, logs and ``metrics.jsonl``;
every rank computes in :meth:`Trainer.test`.
"""

from __future__ import annotations

import contextlib
import copy
import glob
import itertools
import logging
import math
import os
import re
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from founddiff_tpu_torch.config import Config
from founddiff_tpu_torch.data.loader import Loader, cycle
from founddiff_tpu_torch.ops.metrics import compute_psnr, compute_rmse, compute_ssim
from founddiff_tpu_torch.parallel.mesh import replicate_state
from founddiff_tpu_torch.pipeline import make_hoisted_sampler
from founddiff_tpu_torch.train.ema import ema_update
from founddiff_tpu_torch.train.state import clip_by_global_norm_, make_optimizer
from founddiff_tpu_torch.utils import trace
from founddiff_tpu_torch.utils.images import hu_preview_window, save_image
from founddiff_tpu_torch.utils.logger import get_logger
from founddiff_tpu_torch.utils.metrics_log import MetricsLogger


def _start_trace():
    """A profiler window with the program's spans recording, so that its
    trace shows the ``train.*`` ranges: ``(profiler, window)``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, record_shapes=True)
    window = contextlib.ExitStack()
    window.enter_context(prof)
    window.enter_context(trace.recording())
    return prof, window


def _stop_trace(traced, profile_dir: str) -> None:
    """Ends the window of :func:`_start_trace` and writes its Chrome trace
    under ``profile_dir``."""
    prof, window = traced
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    window.close()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace-{os.getpid()}.json"))


class Trainer:
    """Trains ``model`` (from ``factory.build(..., train=True)``) under
    ``diffusion``'s loss with ``config.train``; ``train_dataset`` /
    ``sample_dataset``: map-style datasets of ``[NDCT, LDCT]`` NHWC pairs
    (None when the caller passes batches or does not evaluate); ``mesh``:
    the ('data', 'seq') mesh of ``parallel.make_mesh`` for data-parallel
    training (None: one process)."""

    def __init__(self, diffusion, model, config: Config, train_dataset=None,
                 sample_dataset=None, mesh=None):
        tcfg = config.train
        self.diffusion, self.model, self.config = diffusion, model, config
        self.mesh = mesh
        # only rank 0 writes files (src/DADiff.py:1627,1723,1766)
        self.is_main = not dist.is_initialized() or dist.get_rank() == 0
        self.num_unet = config.model.num_unet
        self.device = next(model.parameters()).device
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt = make_optimizer(self.params, self.num_unet, tcfg.train_lr, tcfg.adam_betas)
        if mesh is not None:
            replicate_state(model)
        self.ema = copy.deepcopy(model).eval().requires_grad_(False)
        self.ema_step = 0
        self.step = 0
        self.generator = torch.Generator().manual_seed(tcfg.seed)
        self.checkpoint_folder = tcfg.checkpoint_folder
        self.results_folder = os.path.join(self.checkpoint_folder, "sample")
        self._diffusion = copy.copy(diffusion)
        self._diffusion.model_fn = self._model_fn
        self.train_dataset, self.sample_dataset = train_dataset, sample_dataset
        if train_dataset is not None:
            self.dl = cycle(Loader(train_dataset,
                                   batch_size=tcfg.train_batch_size * tcfg.gradient_accumulate_every,
                                   shuffle=True, seed=tcfg.seed))
        if sample_dataset is not None:
            self.sample_loader = cycle(Loader(sample_dataset, batch_size=tcfg.num_samples,
                                              shuffle=True, seed=tcfg.seed + 1))
        self.train_logger = None
        self._metrics = None

    @property
    def metrics(self) -> MetricsLogger:
        """``metrics.jsonl`` in the checkpoint folder, opened at first use."""
        if self._metrics is None:
            tcfg = self.config.train
            self._metrics = MetricsLogger(os.path.join(self.checkpoint_folder, "metrics.jsonl"),
                                          use_wandb=tcfg.use_wandb, project=tcfg.wandb_project,
                                          name=self.config.name)
        return self._metrics

    def _model_fn(self, x_in, time, x_self_cond=None):
        if self.config.train.mixed_precision != "bf16":
            return self.model(x_in, time, x_self_cond=x_self_cond)
        bf16 = torch.bfloat16
        named = itertools.chain(self.model.named_parameters(), self.model.named_buffers())
        tensors = {n: t.to(bf16) for n, t in named if t.dtype == torch.float32}
        out = torch.func.functional_call(
            self.model, tensors, (x_in.to(bf16), time),
            {"x_self_cond": None if x_self_cond is None else x_self_cond.to(bf16)})
        if torch.is_tensor(out):  # the vanilla UNet's one prediction
            return out.float()
        return [o.float() if torch.is_tensor(o) else o for o in out]

    @trace.traced("train.step", device=True)
    def train_step(self, batch) -> List[float]:
        """One optimisation step on ``batch = (gt, ld)``, NHWC in [0, 1] with
        ``train_batch_size * gradient_accumulate_every`` slices; returns the
        per-UNet losses averaged over the microbatches."""
        tcfg = self.config.train
        accum = tcfg.gradient_accumulate_every
        device = self.device
        gt, ld = (torch.as_tensor(b).to(device) for b in batch[:2])
        micro = gt.shape[0] // accum
        for p in self.params:
            p.grad = None
        losses = torch.zeros(self.num_unet, device=device)
        for i in range(accum):
            part = slice(i * micro, (i + 1) * micro)
            g, l, draws = gt[part], ld[part], dict(generator=self.generator)
            with trace.span("train.forward_loss", device=True):
                if self.mesh is not None:
                    # the draws of ``loss`` at the global microbatch, in its
                    # order; this rank's rows of them and of the batch
                    with trace.span("train.draws"):
                        t = torch.randint(0, self.diffusion.num_timesteps, (micro,),
                                          generator=self.generator)
                        noise = torch.randn((micro,) + tuple(gt.shape[1:]),
                                            generator=self.generator)
                    rows = self.mesh.rows(micro)
                    g, l, draws = g[rows], l[rows], dict(draws, t=t[rows], noise=noise[rows])
                if self.diffusion.condition:
                    out = self._diffusion.loss([g, l], **draws)
                else:  # generation: the single image stream (src/DADiff.py:1691-1694)
                    out = [self._diffusion.loss(g, **draws)]
            with trace.span("train.backward", device=True):
                (sum(out) / accum).backward()
            losses += torch.stack([torch.as_tensor(l, device=device).detach().float()
                                   for l in out]) / accum
        with trace.span("train.update", device=True):
            if self.mesh is not None and self.mesh.groups["data"] is not None:
                with trace.span("train.all_reduce", device=True):
                    losses = self._average_over_data(losses)
            with trace.span("train.clip", device=True):
                clip_by_global_norm_(self.params, tcfg.max_grad_norm)
            with trace.span("train.optimizer", device=True):
                self.opt.step()
            self.ema_step = ema_update(list(self.ema.parameters()),
                                       list(self.model.parameters()), self.ema_step,
                                       beta=tcfg.ema_decay, update_every=tcfg.ema_update_every)
        self.step += 1
        return losses.tolist()

    @torch.no_grad()
    def _average_over_data(self, losses: torch.Tensor) -> torch.Tensor:
        """The gradients (in place) and ``losses`` averaged over the mesh's
        data group: one flat ``all_reduce``."""
        grads = [p.grad for p in self.params if p.grad is not None]
        flat = _flatten_dense_tensors(grads + [losses])
        dist.all_reduce(flat, group=self.mesh.groups["data"])
        flat /= self.mesh.shape["data"]
        out = _unflatten_dense_tensors(flat, grads + [losses])
        for g, avg in zip(grads, out):
            g.copy_(avg)
        return out[-1]

    def train(self, batches: Optional[Iterable] = None, log_every: int = 50,
              profile_dir: Optional[str] = None, profile_steps: tuple = (10, 15)) -> None:
        """The training loop (src/DADiff.py:1673-1763) until
        ``train_num_steps``, over ``(gt, ld)`` ``batches`` or, when none are
        given, the ``train_dataset`` loader; logs to ``train.log`` and
        ``metrics.jsonl`` in the checkpoint folder, previews, evaluates and
        saves at the JAX trainer's cadence (trainer.py:220-281).

        ``profile_dir`` traces the steps from ``profile_steps[0]`` up to
        ``profile_steps[1]`` with ``torch.profiler`` (CPU and, on the card,
        CUDA activities, shapes recorded), as the JAX loop does with
        ``jax.profiler``, with the program's spans recording (the
        ``train.*`` ranges), and writes a Chrome trace under ``profile_dir``;
        without it no profiler is made."""
        tcfg = self.config.train
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        log = None
        if self.is_main:
            self.train_logger = log = get_logger(os.path.join(self.checkpoint_folder,
                                                              "train.log"))
        stream = iter(batches) if batches is not None else self.dl
        prof = None
        t0 = time.time()
        while self.step < tcfg.train_num_steps:
            if profile_dir and self.step == profile_steps[0]:
                prof = _start_trace()
            if prof is not None and self.step == profile_steps[1]:
                _stop_trace(prof, profile_dir)
                prof = None
            batch = next(stream, None)
            if batch is None:
                break
            losses = self.train_step(batch)
            step = self.step
            if log is not None and (step % log_every == 0 or step == 1):
                rate = log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                m = {f"loss_unet{i}": v for i, v in enumerate(losses)}
                log.info(f"step {step}/{tcfg.train_num_steps} "
                         + " ".join(f"{k}: {v:.6f}" for k, v in m.items())
                         + f" ({rate:.2f} it/s)")
                self.metrics.log({**m, "it_per_sec": rate}, step=step)
            every = tcfg.save_and_sample_every
            if step % every == 0:
                milestone = step // every
                if self.sample_dataset is not None and self.is_main:
                    self.preview(milestone)
                if step > every * 10 * 4 and step % (every * 10) == 0:
                    self.save(milestone)
                    if self.sample_dataset is not None:
                        self.test(last=True, fid=tcfg.fid_eval)
        if prof is not None:  # the loop ended inside the traced steps
            _stop_trace(prof, profile_dir)
        if log is not None:
            log.info("training complete")

    def _ckpt_path(self, milestone) -> str:
        return os.path.join(self.results_folder, f"model-{milestone}.pt")

    def save(self, milestone) -> str:
        """``model-<milestone>.pt`` in the reference layout
        (src/DADiff.py:1626-1646): ``model`` is the diffusion state dict
        (``model.<port name>``), ``ema`` the ema_pytorch state dict
        (``ema_model.model.<port name>``).  Only rank 0 writes."""
        path = self._ckpt_path(milestone)
        if not self.is_main:
            return path
        os.makedirs(self.results_folder, exist_ok=True)
        data = {
            "step": self.step,
            "model": {f"model.{k}": v for k, v in self.model.state_dict().items()},
            "opt": self.opt.state_dict(),
            "ema": {"initted": torch.tensor(True), "step": torch.tensor(self.ema_step),
                    **{f"ema_model.model.{k}": v for k, v in self.ema.state_dict().items()}},
        }
        torch.save(data, path)
        self._prune_checkpoints()
        return path

    def _prune_checkpoints(self) -> None:
        keep = self.config.train.keep_checkpoints
        if keep <= 0:
            return
        found = []
        for p in glob.glob(os.path.join(self.results_folder, "model-*.pt")):
            m = re.fullmatch(r"model-(\d+)\.pt", os.path.basename(p))
            if m:
                found.append((int(m.group(1)), p))
        for _, p in sorted(found)[:-keep]:
            os.remove(p)

    def load(self, milestone) -> None:
        """Resume from this run's ``model-<milestone>.pt``: the weights and
        step as :meth:`load_torch` reads them, then the optimizer and the
        EMA's step."""
        data = self.load_torch(self._ckpt_path(milestone))
        self.opt.load_state_dict(data["opt"])
        self.ema_step = int(data["ema"]["step"])

    def load_torch(self, path: str) -> dict:
        """Load a reference ``model-<n>.pt`` (src/DADiff.py:1626-1646): the
        online weights from ``data['model']`` (``model.<name>``), the EMA's
        from ``data['ema']`` (``ema_model.model.<name>``), the step.  The
        port's names are the reference's, so this strips the prefixes; every
        parameter and buffer of the model must be in the file (keys the port
        does not build, such as the CLIP text embedding, or the tower of a
        run without it, are skipped).  The optimizer starts afresh, as in the
        JAX ``load_reference_checkpoint`` (utils/torch_convert.py:484-517).
        The file is unpickled with ``weights_only=True``: tensors, numbers,
        strings and containers only.  Returns the file's dict."""
        data = torch.load(path, map_location=self.device, weights_only=True)
        strip = lambda sd, pre: {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        parts = [(self.model, strip(data["model"], "model."))]
        if "ema" in data:
            parts.append((self.ema, strip(data["ema"], "ema_model.model.")))
        for module, sd in parts:
            own = module.state_dict()
            missing = [k for k in own if k not in sd]
            if missing:
                raise RuntimeError(f"load_torch: {path} lacks {len(missing)} keys of the model, "
                                   f"e.g. {missing[:4]}")
            module.load_state_dict({k: sd[k] for k in own})
        if "ema" not in data:
            self.ema.load_state_dict(self.model.state_dict())
        self.step = self.ema_step = int(data.get("step", 0))
        return data

    def sample(self, x_input01=None, generator: Optional[torch.Generator] = None,
               noise=None, compute_dtype=None, use_test_schedule: bool = False):
        """Samples with the EMA weights, as the JAX ``Trainer.sample``
        (trainer.py:341-389) routes them.  Conditional: with the tower,
        hoisted-tower sampling of the conditioning slices ``x_input01``;
        without it, ``diffusion.sample`` of them (``noise``: the initial
        noise, or every draw of full-T sampling).  Generation (vanilla DDPM):
        ``diffusion.sample(batch_size=num_samples)``, ``x_input01`` unused
        (``noise``: every draw, as ``GaussianDiffusion.sample`` takes them).
        The training schedule unless ``use_test_schedule``."""
        d = copy.copy(self.diffusion)
        d.model_fn = lambda x, t, x_self_cond=None: self.ema(x, t, x_self_cond=x_self_cond)
        if not self.diffusion.condition:
            return d.sample(batch_size=self.config.train.num_samples, generator=generator,
                            noise=noise)
        if not hasattr(self.ema, "encode"):  # no tower to hoist
            return d.sample(x_input01, last=True, use_test_schedule=use_test_schedule,
                            generator=generator, noise=noise)[-1]
        sampler = make_hoisted_sampler(self.ema, self.diffusion,
                                       use_test_schedule=use_test_schedule,
                                       compute_dtype=compute_dtype)
        return sampler(x_input01, generator=generator, noise=noise)

    def preview(self, milestone) -> torch.Tensor:
        """The preview of ``milestone`` (src/DADiff.py:1765-1815): one batch of
        ``sample_dataset``'s LDCT slices denoised on the training schedule,
        saved through the HU display window as ``sample-<milestone>.png``
        (``.png.npy`` without PIL)."""
        batch = next(self.sample_loader)
        x = torch.from_numpy(np.asarray(batch[1])).to(self.device)
        img = self.sample(x, generator=self.generator)
        os.makedirs(self.results_folder, exist_ok=True)
        save_image(hu_preview_window(img.float().cpu().numpy()),
                   os.path.join(self.results_folder, f"sample-{milestone}.png"),
                   nrow=int(max(1, np.sqrt(self.config.train.num_samples))))
        return img

    # the test protocol (src/DADiff.py:1817-1966)

    def _slice_noise(self, index: int, shape) -> torch.Tensor:
        """The initial noise of test slice ``index`` (the one place ``test``
        draws it; the later draws of full-T sampling come from the trainer's
        generator)."""
        return torch.randn(tuple(shape), generator=self.generator)

    def _compute_fid(self, preds, gts) -> float:
        """FID between predicted and ground-truth slices with the EMA's frozen
        Dose-CLIP visual tower as the feature extractor; NaN without a tower."""
        tower = getattr(self.ema, "dose_encoder", None)
        if tower is None:
            if self.train_logger is not None:
                self.train_logger.info("fid skipped: no dose_encoder params (unconditional run)")
            return float("nan")
        from founddiff_tpu_torch.utils.fid import compute_fid, make_clip_extractor

        return compute_fid(torch.cat(preds), torch.cat(gts), make_clip_extractor(tower))

    @torch.no_grad()
    def test(self, last: bool = True, save_npy: bool = False, fid: bool = False,
             fid_limit: int = 512) -> Dict[str, float]:
        """Denoises every slice of ``sample_dataset`` (batch 1, in order) with
        the EMA weights on the test schedule and scores it against its NDCT:
        the summary ``{psnr, ssim, rmse[, fid_doseclip]}``, logged with the
        per-anatomy and per-dose means of ``data.eval_counts`` /
        ``eval_doses`` in the JAX text format, and as ``test_*`` in
        ``metrics.jsonl``.  ``save_npy`` writes each prediction as
        ``<results_folder>/<slice name>.npy``; ``fid`` computes the Dose-CLIP
        FID over the first ``fid_limit`` slices."""
        assert self.sample_dataset is not None
        os.makedirs(self.checkpoint_folder, exist_ok=True)
        if self.is_main:
            logger = self.train_logger or get_logger(os.path.join(self.checkpoint_folder,
                                                                  "test.log"))
        else:  # every rank computes; rank 0 alone writes
            logger = logging.getLogger("founddiff_tpu_torch.test.quiet")
            logger.propagate, logger.handlers = False, [logging.NullHandler()]
        psnrs: List[float] = []
        ssims: List[float] = []
        rmses: List[float] = []
        fid_pred: List[torch.Tensor] = []
        fid_gt: List[torch.Tensor] = []
        if save_npy:
            os.makedirs(self.results_folder, exist_ok=True)
        loader = Loader(self.sample_dataset, batch_size=1, shuffle=False, drop_last=False)
        for i, items in enumerate(loader):
            gt, ldct = (torch.from_numpy(np.asarray(a)).to(self.device) for a in items[:2])
            pred = self.sample(ldct, noise=self._slice_noise(i, ldct.shape),
                               generator=self.generator, use_test_schedule=True)
            p, s, r = torch.stack([compute_psnr(pred, gt), compute_ssim(pred, gt),
                                   compute_rmse(pred, gt)]).tolist()
            psnrs.append(p)
            ssims.append(s)
            rmses.append(r)
            if fid and len(fid_pred) < fid_limit:
                fid_pred.append(pred)
                fid_gt.append(gt)
            if save_npy and self.is_main:
                name = self.sample_dataset.load_name(i)
                np.save(os.path.join(self.results_folder, name[:-4]),
                        pred.float().cpu().numpy().reshape(pred.shape[1], pred.shape[2]))

        # per-anatomy / per-dose aggregation (src/DADiff.py:1918-1952)
        n_doses = self.config.data.eval_doses
        offset = 0
        for anatomy, length in dict(self.config.data.eval_counts).items():
            block = slice(offset, offset + length * n_doses)
            a_p, a_s, a_r = psnrs[block], ssims[block], rmses[block]
            if a_p:
                logger.info("(%s average mean: psnr: %.4f, ssim: %.4f, rmse: %.4f)"
                            % (anatomy, np.mean(a_p), np.mean(a_s), np.mean(a_r)))
                for d in range(n_doses):
                    seg = slice(d * length, (d + 1) * length)
                    if a_p[seg]:
                        logger.info("(%s dose %2d: psnr: %.4f, ssim: %.4f, rmse: %.4f)"
                                    % (anatomy, d, np.mean(a_p[seg]), np.mean(a_s[seg]),
                                       np.mean(a_r[seg])))
            offset += length * n_doses

        summary = {k: float(np.mean(v)) if v else math.nan
                   for k, v in (("psnr", psnrs), ("ssim", ssims), ("rmse", rmses))}
        if fid and fid_pred:
            # Dose-CLIP features, not InceptionV3: keyed apart from published FIDs
            summary["fid_doseclip"] = float(self._compute_fid(fid_pred, fid_gt))
        if self.is_main:
            self.metrics.log({f"test_{k}": v for k, v in summary.items()}, step=self.step)
        logger.info("test_psnr: {psnr:.4f}, test_ssim: {ssim:.4f}, "
                    "test_rmse: {rmse:.4f}".format(**summary))
        return summary
