from .store import (CheckpointCorrupt, restore_checkpoint, save_checkpoint,
                    template_of)

__all__ = ["CheckpointCorrupt", "restore_checkpoint", "save_checkpoint",
           "template_of"]
