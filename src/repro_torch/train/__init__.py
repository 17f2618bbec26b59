"""Training substrate: optimizers, schedules, checkpointing, fault tolerance."""
from .checkpoint import CheckpointManager  # noqa: F401
from .optimizer import adafactor, adamw, get_optimizer  # noqa: F401
from .trainer import TrainConfig, Trainer, init_state, make_train_step  # noqa: F401
