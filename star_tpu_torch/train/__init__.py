from .losses import fourier_split, star_sr_loss
from .trainer import (TrainConfig, TrainState, cast_frozen, is_trainable,
                      make_optimizer, make_train_state, make_train_step,
                      stop_frozen_grads, trainable_mask)
from .ema import init_ema, update_ema
