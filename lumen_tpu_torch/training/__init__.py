"""Training (twin of ``lumen_tpu/training``): contrastive CLIP fine-tuning
over a process mesh (data-parallel batches, tensor-parallel blocks), with
checkpoint/resume on ``torch.distributed.checkpoint``."""

from .checkpoint import TrainCheckpointer
from .clip_trainer import ClipTrainer, TrainConfig, contrastive_loss

__all__ = ["ClipTrainer", "TrainCheckpointer", "TrainConfig", "contrastive_loss"]
