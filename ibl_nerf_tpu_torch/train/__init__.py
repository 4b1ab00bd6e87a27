"""Training: losses with the staged warm-up, and the train step."""

from ibl_nerf_tpu_torch.train.losses import LossConfig, Phase, compute_losses, resolve_phase
from ibl_nerf_tpu_torch.train.step import (
    TrainState,
    build_optimizer,
    init_train_state,
    make_train_step,
)
