from dsl_tpu_torch.train.train_state import (  # noqa: F401
    TrainState, create_train_state, ema_update)
from dsl_tpu_torch.train.optim import (  # noqa: F401
    MMCVAdamW, MMCVSGD, build_lr_schedule, build_momentum_schedule,
    build_optimizer_from_cfg, frozen_backbone_mask, make_optimizer)
from dsl_tpu_torch.train.train_step import (  # noqa: F401
    make_eval_step, make_train_step)
