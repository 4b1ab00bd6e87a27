"""Training entry point.

    python -m ibl_nerf_tpu_torch.cli.train --config <scene config> [flags]

Same flags and config files as `python -m ibl_nerf_tpu.cli.train`
(`cli/config.py`). Trains on the CUDA device and raises when there is
none; it never falls back to the CPU.
"""

from __future__ import annotations

from ibl_nerf_tpu_torch.cli.config import export_config, parse_with_includes
from ibl_nerf_tpu_torch.train.loop import check_supported_flags, train
from ibl_nerf_tpu_torch.utils.device import pin_f32_matmul, resolve_device


def main(argv=None):
    args = parse_with_includes(argv)
    device = resolve_device("cuda")
    pin_f32_matmul()
    check_supported_flags(args)
    export_config(args, args.basedir)
    return train(args, device=device)


if __name__ == "__main__":
    main()
