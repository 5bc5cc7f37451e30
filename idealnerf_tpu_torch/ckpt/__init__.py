from idealnerf_tpu_torch.ckpt.manager import CheckpointManager, partial_restore

__all__ = ["CheckpointManager", "partial_restore"]
