from .store import (AsyncCheckpointer, CheckpointCorrupt, latest_step,
                    restore_checkpoint, save_checkpoint, template_of)

__all__ = ["AsyncCheckpointer", "CheckpointCorrupt", "latest_step",
           "restore_checkpoint", "save_checkpoint", "template_of"]
