"""Training substrate of the port: optimizer, trainer, checkpoints (the
names of ``repro.training``)."""
from repro_torch.training import checkpoint
from repro_torch.training.optim import AdamW, constant, warmup_cosine
from repro_torch.training.trainer import Trainer, init_state, make_train_step

__all__ = ["checkpoint", "AdamW", "constant", "warmup_cosine", "Trainer",
           "init_state", "make_train_step"]
