"""Port a PyTorch reference checkpoint (.tar) into a port checkpoint.

    python -m ibl_nerf_tpu_torch.cli.port_checkpoint \
        --tar logs/kitchen/100000.tar --out logs_torch/kitchen \
        --coarse_radiance_number 3

Counterpart of `python -m ibl_nerf_tpu.cli.port_checkpoint`: the
reference's coarse and fine fields become the port's params, with a
fresh named Adam, saved as `{out}/ckpt_{step:06d}/state.pt` at the
tar's `global_step`, so `cli.test` and `cli.render` (or a resumed
`cli.train`) read them. The params live on the CUDA device unless
`device` is named.
"""

from __future__ import annotations

import argparse

from ibl_nerf_tpu_torch.train import checkpoint as ckpt_lib
from ibl_nerf_tpu_torch.train.step import build_optimizer, init_train_state
from ibl_nerf_tpu_torch.utils.device import resolve_device
from ibl_nerf_tpu_torch.utils.port import load_reference_checkpoint


def main(argv=None, device=None) -> str:
    ap = argparse.ArgumentParser("port_checkpoint")
    ap.add_argument("--tar", required=True)
    ap.add_argument("--out", required=True, help="logdir for the port checkpoint")
    ap.add_argument("--coarse_radiance_number", type=int, default=3)
    ap.add_argument("--netdepth", type=int, default=8)
    ap.add_argument("--lrate", type=float, default=5e-4)
    ap.add_argument("--lrate_decay", type=int, default=500)
    args = ap.parse_args(argv)
    device = resolve_device(device)

    coarse, fine, step, elapsed = load_reference_checkpoint(
        args.tar, args.coarse_radiance_number, args.netdepth, device)
    variables = {"coarse": coarse}
    if fine is not None:
        variables["fine"] = fine
    optimizer = build_optimizer(variables, lrate=args.lrate, lrate_decay=args.lrate_decay)
    state = init_train_state(variables, optimizer, step=step)
    path = ckpt_lib.save_checkpoint(args.out, step, state, elapsed)
    print(f"ported step {step} (elapsed {elapsed:.0f}s) -> {path}")
    return path


if __name__ == "__main__":
    main()
