"""Dose-CLIP training (mirror of ``tools/train_doseclip.py``).

Fine-tunes the CLIPIQA prompt context and heads on ``DoseDataset`` pairs (two
augmentations of a slice and its dose label) so that the dose probability
tracks 1 / dose, the dose embeddings of the two views agree (BMC loss) and
the content embedding is augmentation-invariant (InfoNCE); the CLIP towers
stay frozen:

    python -m founddiff_tpu_torch.tools.train_doseclip --data_root /path/to/mayo \\
        [--steps 10000] [--batch_size 8] [--clip_weights CLIP.pt --bpe_path VOCAB] \\
        [--device cuda]

The trained set is the JAX tool's (``train_doseclip.py:121-133``): every
tensor outside ``clip_model``, so beside ``ctx`` and the heads also the prompt
token embeddings ``token_prefix`` and ``token_suffix``, which flax holds as
parameters and the reference and the port as buffers.  They take gradients
for the run and stay buffers of ``CLIPIQA``.  ``--image_size`` is parsed and
not used, as in JAX.  The output, ``<out>/dose_clip_final.pth``, is
``CLIPIQA``'s state dict under the reference names (the JAX tool writes
Orbax); it loads strictly as the denoiser's dose encoder.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch
import torch.nn.functional as F

TRAINED = ("prompt_learner.ctx", "prompt_learner.token_prefix", "prompt_learner.token_suffix",
           "head1.", "head2.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the Dose-CLIP prompt context and heads")
    p.add_argument("--data_root", required=True)
    p.add_argument("--phase", default="train512")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--out", default="checkpoints/dose_clip")
    p.add_argument("--bmc_sigma", type=float, default=1.0)
    p.add_argument("--clip_weights", default=None,
                   help="torch CLIP/CLIPIQA state dict (.pt/.pth) for the frozen towers; the "
                        "prompts are then bootstrapped from its token-embedding table through "
                        "the BPE tokenizer (reference src/DACLIP.py:906-926)")
    p.add_argument("--bpe_path", default=None,
                   help="bpe_simple_vocab_16e6.txt.gz path (default: $FOUNDDIFF_CLIP_BPE or "
                        "~/.cache/clip/)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; 'cpu' runs on the host)")
    return p.parse_args(argv)


def trained_tensors(model):
    """The tensors Adam updates, by name: ``ctx``, ``token_prefix``,
    ``token_suffix`` and the two heads."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    return {k: v for k, v in named.items() if k.startswith(TRAINED)}


def freeze_towers(model):
    """Towers frozen, the JAX tool's trained set taking gradients (the two
    prompt buffers included); returns the trained tensors by name."""
    model.requires_grad_(False)
    trained = trained_tensors(model)
    for t in trained.values():
        t.requires_grad_(True)
    return trained


def _views(v, device):
    """A [B, H, W, 1] view in [0, 1] as the tower's RGB input in [-1, 1]."""
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    return (v * 2.0 - 1.0).repeat_interleave(3, dim=-1)


def loss_fn(model, batch, bmc_sigma: float = 1.0):
    """``(loss, {"reg", "bmc", "nce"})`` of ``train_doseclip.py:138-155``
    for ``batch = ((v1, v2), labels)``: the dose probability of each view
    against 1 / label (MSE), BMC between the views' dose embeddings with
    noise variance ``bmc_sigma ** 2``, InfoNCE (temperature 0.07) between
    their content embeddings.  The frozen tower runs without autograd."""
    from founddiff_tpu_torch.ops.losses import bmc_loss

    (v1, v2), labels = batch
    device = next(model.parameters()).device
    outs = []
    for v in (v1, v2):
        x = _views(v, device)
        with torch.no_grad():
            features = model.clip_model.encode_image(x)
        outs.append(model(x, features=features))
    (p1, d1, c1), (p2, d2, c2) = outs
    target = (1.0 / torch.as_tensor(labels).to(device=device, dtype=torch.float32))[:, None]
    reg = ((p1 - target) ** 2 + (p2 - target) ** 2).mean()
    bmc = bmc_loss(d1, d2, torch.tensor(bmc_sigma, device=device) ** 2)
    logits = c1 @ c2.t() / 0.07
    nce = -F.log_softmax(logits, dim=-1).diagonal().mean()
    return reg + bmc + nce, {"reg": reg, "bmc": bmc, "nce": nce}


def step(model, opt, batch, bmc_sigma: float = 1.0):
    """One Adam step on the trained set; returns ``(loss, aux)`` as floats."""
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(model, batch, bmc_sigma)
    loss.backward()
    opt.step()
    return loss.item(), {k: v.item() for k, v in aux.items()}


def bootstrap_from_clip(model, path: str, bpe_path=None, logger=None) -> None:
    """The towers of a torch CLIP or CLIPIQA file (token embedding left
    out; what the file lacks keeps its init, as the JAX tool converts what
    it finds), and the prompts from its token-embedding table through the
    BPE tokenizer; exits when the prompts' EOT positions are not the
    model's."""
    import numpy as np

    from founddiff_tpu_torch.models.tokenizer import ClipTokenizer, bootstrap_prompt_learner
    from founddiff_tpu_torch.utils.clip_build import (TOKEN_EMBEDDING, clip_prefix,
                                                      load_clipiqa, load_torch_state)

    sd = load_torch_state(path)
    missing = load_clipiqa(model, sd, towers_only=True, strict=False)
    if logger:
        logger.info("loaded %d CLIP tensors from %s", len(model.clip_model.state_dict())
                    - len(missing), path)
    table = sd[clip_prefix(sd) + TOKEN_EMBEDDING].float().numpy()
    tok = ClipTokenizer(bpe_path=bpe_path)
    prompts, eot, _ = bootstrap_prompt_learner(np.asarray(table), tok)
    expected = model.prompt_learner.eot_indices
    if tuple(eot) != tuple(expected):
        raise SystemExit(f"tokenized prompt EOT positions {eot} != model config {expected}; "
                         "pass matching prompt_eot_indices to CLIPIQA")
    with torch.no_grad():
        for k, v in prompts.items():
            getattr(model.prompt_learner, k).copy_(torch.from_numpy(v))
    if logger:
        logger.info("bootstrapped prompt buffers from token table, eot=%s", eot)


def main(argv=None):
    args = parse_args(argv)

    from founddiff_tpu_torch.data import DoseDataset, Loader, cycle
    from founddiff_tpu_torch.factory import init_params
    from founddiff_tpu_torch.models.clip import CLIPIQA
    from founddiff_tpu_torch.utils.device import resolve
    from founddiff_tpu_torch.utils.logger import get_logger

    device = resolve(args.device, "train_doseclip")
    os.makedirs(args.out, exist_ok=True)
    logger = get_logger(os.path.join(args.out, "train.log"))
    loader = cycle(Loader(DoseDataset(args.phase, root=args.data_root),
                          batch_size=args.batch_size, shuffle=True))
    model = CLIPIQA()
    init_params(model, torch.Generator().manual_seed(0))
    if args.clip_weights:
        bootstrap_from_clip(model, args.clip_weights, args.bpe_path, logger)
    model.to(device).eval()
    trained = freeze_towers(model)
    opt = torch.optim.Adam(list(trained.values()), lr=args.lr, eps=1e-8)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times, bad = [], 0
    for i in range(args.steps):
        t0 = time.perf_counter()
        loss, aux = step(model, opt, next(loader), args.bmc_sigma)
        times.append(time.perf_counter() - t0)
        bad += not all(math.isfinite(v) for v in (loss, *aux.values()))
        if i % 50 == 0:
            logger.info(f"step {i}: loss {loss:.4f} "
                        + " ".join(f"{k}={v:.4f}" for k, v in aux.items()))
    if times:
        rest = times[1:] or times
        peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda"
                else float("nan"))
        logger.info(f"{len(times)} steps, {bad} with a non-finite loss: first step "
                    f"{times[0]:.3f} s, then {len(rest) / sum(rest):.3f} steps/s; peak memory "
                    f"{peak:.2f} GiB")
    for t in trained.values():
        t.requires_grad_(False)
    path = os.path.join(args.out, "dose_clip_final.pth")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    logger.info("done: %s", path)
    return model


if __name__ == "__main__":
    main()
