"""Training of the analysis stage, as ``voicefixer_tpu/train/``: the losses,
the optimizer and its schedule, one step, checkpoints, paired data and
augmentation."""

from voicefixer_tpu_torch.train.step import (  # noqa: F401
    TrainState, init_train_state, make_train_step)
