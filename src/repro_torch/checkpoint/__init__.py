from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          reshard_members,
                                          restore_checkpoint,
                                          save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "latest_step", "reshard_members"]
