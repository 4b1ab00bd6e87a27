"""Training entry point.

    python -m ibl_nerf_tpu_torch.cli.train --config <scene config> [flags]

Same flags and config files as `python -m ibl_nerf_tpu.cli.train`
(`cli/config.py`). Trains on the CUDA device and raises when there is
none; it never falls back to the CPU. With `--num_processes P > 1` each
process joins a `torch.distributed` group at `--coordinator_address`
(host:port) as `--process_id` and trains on `cuda:<local rank>`; one
command per process, e.g. on one host with two cards:

    python -m ibl_nerf_tpu_torch.cli.train --config <cfg> --num_processes 2 \\
        --coordinator_address localhost:29500 --process_id 0   # and 1
"""

from __future__ import annotations

import torch

from ibl_nerf_tpu_torch.cli.config import export_config, parse_with_includes
from ibl_nerf_tpu_torch.parallel import distributed
from ibl_nerf_tpu_torch.train.loop import check_supported_flags, train
from ibl_nerf_tpu_torch.utils.device import pin_f32_matmul, resolve_device


def main(argv=None, backend: str | None = None):
    """Parse `argv` and train. `backend` names the process group's
    backend (NCCL when None)."""
    args = parse_with_includes(argv)
    resolve_device("cuda")
    pin_f32_matmul()
    check_supported_flags(args)
    pid = 0
    if args.num_processes > 1:
        pid, _ = distributed.initialize(args.coordinator_address, args.num_processes,
                                        args.process_id, backend=backend)
    device = resolve_device(distributed.local_device("cuda"))
    torch.cuda.set_device(device)
    if pid == 0:
        export_config(args, args.basedir)
    return train(args, device=device)


if __name__ == "__main__":
    main()
