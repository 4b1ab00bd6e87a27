"""Training: losses with the staged warm-up, the train step, checkpoints,
health checks and the training driver (`train.loop`)."""

from ibl_nerf_tpu_torch.train.losses import LossConfig, Phase, compute_losses, resolve_phase
from ibl_nerf_tpu_torch.train.step import (
    TrainState,
    build_optimizer,
    init_train_state,
    make_train_step,
)
