from repro_torch.lm.train.optimizer import AdamW, OptState, cosine_schedule
from repro_torch.lm.train.train_step import make_train_step

__all__ = ["AdamW", "OptState", "cosine_schedule", "make_train_step"]
