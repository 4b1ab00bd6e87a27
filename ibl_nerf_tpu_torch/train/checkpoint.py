"""Checkpoint / resume.

Counterpart of ibl_nerf_tpu/train/checkpoint.py: checkpoints live in
`{logdir}/ckpt_{step:06d}` and carry the params, the named Adam state,
the step and the elapsed training time; restore takes an explicit path
(`ft_path`) over a target step over the newest checkpoint in the logdir,
and the learning-rate schedules continue from the restored Adam counts.

Each directory holds one `torch.save` file, written to a temporary name
and renamed, so a run killed mid-write leaves no half checkpoint. The
saved step is the state's count of completed updates, so a restored run
resumes at the first update the checkpoint does not contain. Under a
`torch.distributed` process group every process calls save: rank 0
writes, and all of them wait at a barrier until it has.
"""

from __future__ import annotations

import os
import re

import torch
import torch.distributed as dist

from ibl_nerf_tpu_torch.train.step import GroupState, TrainState, _leaves, _unflatten

_CKPT_RE = re.compile(r"ckpt_(\d+)$")
STATE_FILE = "state.pt"


def _ckpt_dir(logdir: str, step: int) -> str:
    return os.path.join(os.path.abspath(logdir), f"ckpt_{step:06d}")


def list_checkpoints(logdir: str) -> list[tuple[int, str]]:
    """(step, path) of every checkpoint directory in `logdir`, oldest first."""
    if not os.path.isdir(logdir):
        return []
    out = []
    for name in sorted(os.listdir(logdir)):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(os.path.abspath(logdir), name)))
    return sorted(out)


def save_checkpoint(logdir: str, step: int, state: TrainState, elapsed_time: float) -> str:
    """Write `state` to `{logdir}/ckpt_{step:06d}`; returns that path.
    Under a process group only rank 0 writes, and every rank returns
    once it has."""
    path = _ckpt_dir(logdir, step)
    group = dist.is_available() and dist.is_initialized()
    if not group or dist.get_rank() == 0:
        _write(path, state, elapsed_time)
    if group:
        dist.barrier()
    return path


def _write(path: str, state: TrainState, elapsed_time: float) -> None:
    os.makedirs(path, exist_ok=True)
    payload = {
        "variables": _unflatten(state.variables,
                                [p.detach() for p in _leaves(state.variables)]),
        "opt_state": {name: {"mu": st.mu, "nu": st.nu, "count": st.count, "seen": st.seen}
                      for name, st in state.opt_state.items()},
        "step": int(state.step),
        "elapsed_time": float(elapsed_time),
    }
    tmp = os.path.join(path, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def find_checkpoint(logdir: str, ft_path: str | None = None,
                    target_step: int = -1) -> str | None:
    """The checkpoint directory a restore reads: `ft_path`, else
    `ckpt_{target_step:06d}`, else the newest in `logdir`; None when it
    does not exist."""
    if ft_path and ft_path != "None":
        path = ft_path
    elif target_step > 0:
        path = _ckpt_dir(logdir, target_step)
    else:
        ckpts = list_checkpoints(logdir)
        path = ckpts[-1][1] if ckpts else None
    return path if path is not None and os.path.isdir(path) else None


def checkpoint_step(path: str, state: TrainState) -> int:
    """The update index a checkpoint directory is named after (JAX's
    saved step), or the state's count when the name carries none."""
    m = _CKPT_RE.match(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else int(state.step)


def _same_structure(a, b) -> bool:
    """The same keys, list lengths and leaf shapes, in any key order."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same_structure(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return isinstance(b, torch.Tensor) and a.shape == b.shape


def restore_checkpoint(logdir: str, state: TrainState, ft_path: str | None = None,
                       target_step: int = -1):
    """Restore into the structure of `state`, on the device of its params.

    Returns (state, elapsed_time, found); found=False leaves state
    untouched (a fresh start when there is no checkpoint).
    """
    path = find_checkpoint(logdir, ft_path, target_step)
    if path is None:
        return state, 0.0, False

    restored = torch.load(os.path.join(path, STATE_FILE),
                          map_location=_leaves(state.variables)[0].device, weights_only=True)
    if not _same_structure(state.variables, restored["variables"]):
        raise ValueError(f"checkpoint {path} does not match the model's parameters")
    # the saved key order, which the saved Adam moments follow
    variables = _unflatten(restored["variables"],
                           [p.clone().requires_grad_(True) for p in _leaves(restored["variables"])])
    opt_state = {name: GroupState(mu=st["mu"], nu=st["nu"], count=st["count"],
                                  seen=st["seen"])
                 for name, st in restored["opt_state"].items()}
    new_state = TrainState(variables=variables, opt_state=opt_state,
                           step=int(restored["step"]))
    return new_state, float(restored["elapsed_time"]), True
