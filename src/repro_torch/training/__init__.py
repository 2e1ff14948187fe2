"""Training: AdamW and Adafactor at the reference's leaf granularity, the
int8 cross-pod gradient compression (one pod on one device), a
deterministic data pipeline, atomic checkpoints in the reference's layout,
straggler monitoring and restartable loops."""

from .checkpoint import latest_step, restore, save
from .data import DataConfig, DataPipeline
from .fault import (FaultInjector, RecoveryDecision, RecoveryPlanner,
                    RescheduleRequested, RestartableLoop, RestartPolicy,
                    StragglerConfig, StragglerMonitor)
from .optimizer import AdamState, AdamWConfig, adamw_update, init_adamw
from .trainer import TrainConfig, Trainer, make_train_step
