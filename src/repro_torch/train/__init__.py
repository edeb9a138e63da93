"""Training: loss, AdamW and the train step. Port of ``repro/train``."""
from repro_torch.train.loss import IGNORE, cross_entropy
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         global_norm, init_opt, lr_at)
from repro_torch.train.step import (TrainConfig, build_train_step,
                                    init_train_state)
