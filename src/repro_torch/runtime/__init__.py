from .elastic import ElasticPlan, plan_rescale
from .failure import HeartbeatMonitor, WorkerState
from .trainer import Trainer, TrainerConfig

__all__ = ["HeartbeatMonitor", "WorkerState", "ElasticPlan", "plan_rescale",
           "Trainer", "TrainerConfig"]
