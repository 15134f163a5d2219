"""PyTorch/CUDA port of FoundDiff for NVIDIA Hopper.

Serving path: hoisted-tower conditional DDIM denoising of CT slices
(:func:`founddiff_tpu_torch.pipeline.make_hoisted_sampler` over
:func:`founddiff_tpu_torch.factory.build`).  The three fused kernels of that
path (SS2D block, LayerNorm+adaLN modulation, MambaBlock attention half) are
hand-written CUDA under ``csrc/``, built with nvcc at first use
(:mod:`founddiff_tpu_torch.ops._build`), as are the kernels of the training
path (the scans), of the vanilla DDPM baseline (flash attention) and of the
two opt-in routes ``FOUNDDIFF_GN`` (the GroupNorm pair) and
``FOUNDDIFF_UNIFIED`` (the unified MambaBlock first half).  Every kernel
wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors.

Layout follows the JAX package: images are NHWC, channel concat on the last
axis.  Parameter names follow the reference PyTorch state-dict layout.
"""
