from .adamw import OptState, adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule, make_schedule, wsd_schedule

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "make_schedule", "wsd_schedule"]
