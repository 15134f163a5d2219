"""The distributed environment of one process per card (mirror of
``tools/distributed_env.py``; the reference's HF Accelerate config writer,
reference accelerator.py:1-4).

``torchrun`` sets the variables ``init_distributed`` reads; this tool shows
them, the backend and device this process would take, and can print a
template for starting the processes by hand:

    python -m founddiff_tpu_torch.tools.distributed_env            # this process
    python -m founddiff_tpu_torch.tools.distributed_env --template 4 0 host0:29500
"""

from __future__ import annotations

import argparse
import os

VARS = [
    ("MASTER_ADDR", "rendezvous host (rank 0's)"),
    ("MASTER_PORT", "rendezvous port"),
    ("WORLD_SIZE", "total process count (one per card)"),
    ("RANK", "this process's global rank"),
    ("LOCAL_RANK", "this process's card on its host"),
]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Show or template the torchrun environment")
    p.add_argument("--template", nargs=3, metavar=("NPROC", "RANK", "ADDR:PORT"),
                   help="print the variables of process RANK of NPROC")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card, NCCL; 'cpu': gloo)")
    args = p.parse_args(argv)

    if args.template:
        nproc, rank, addr = args.template
        host, port = addr.rsplit(":", 1)
        print(f"export MASTER_ADDR={host}")
        print(f"export MASTER_PORT={port}")
        print(f"export WORLD_SIZE={nproc}")
        print(f"export RANK={rank}")
        print(f"export LOCAL_RANK={rank}  # the card on this host; on several hosts, "
              "the rank within the host")
        print("# or let torchrun set them: torchrun --nproc_per_node "
              f"{nproc} --master_addr {host} --master_port {port} -m founddiff_tpu_torch ...")
        return

    import torch

    missing = []
    for var, desc in VARS:
        val = os.environ.get(var)
        print(f"{var:12s} = {val if val else '<unset>':24s} # {desc}")
        if not val:
            missing.append(var)
    if torch.device(args.device).type == "cpu":
        backend = "gloo on the CPU"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_env: no CUDA card for NCCL; pass --device cpu "
                               "for gloo on the CPU")
        local = int(os.environ.get("LOCAL_RANK", 0))
        backend = (f"nccl on cuda:{local} ({torch.cuda.get_device_name(local)}, "
                   f"{torch.cuda.device_count()} cards on this host)")
    if {"RANK", "WORLD_SIZE"} & set(missing):
        print(f"\nsingle-process mode (init_distributed() is a no-op); device: {backend}")
    else:
        print(f"\nmulti-process mode: init_distributed() will rendezvous over {backend}")


if __name__ == "__main__":
    main()
