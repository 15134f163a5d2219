"""Work of one serving request: the tower once on the request's slices
(float32 products), then one UNet forward per DDIM step (products at the
trunk's precision, the scan's recurrence on the CUDA cores in float32)."""

from bench_h100.lib import flops, peaks


def work(config: dict, traffic: dict) -> list:
    steps = config["program"]["diffusion"]["sampling_timesteps"]
    unet, scan, tower = flops.unet_forward(config, traffic["batch"])
    return [(tower, peaks.FP32_PRODUCT_FLOPS),
            (steps * unet, peaks.PRODUCT_PEAK[config["precision"]["serve_trunk"]]),
            (steps * scan, peaks.FP32_FLOPS)]
