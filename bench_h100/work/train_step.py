"""Work of one float32 train step: per microbatch the frozen tower's forward
(FoundDiff), and the UNet's forward and backward, counted as three times
the forward's products and scan work (the backward computes the gradient
of both the activations and the weights)."""

from bench_h100.lib import flops, peaks


def work(config: dict, traffic: dict) -> list:
    tc = config["program"]["train"]
    micro, accum = tc["train_batch_size"], tc["gradient_accumulate_every"]
    unet, scan, tower = flops.unet_forward(config, micro)
    return [(accum * (tower + 3 * unet), peaks.FP32_PRODUCT_FLOPS),
            (accum * 3 * scan, peaks.FP32_FLOPS)]
