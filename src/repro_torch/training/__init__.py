"""Training: AdamW (ZeRO-1 under a mesh) and Adafactor at the reference's
leaf granularity, the int8 cross-pod gradient compression over the mesh's
``pod`` ranks, a deterministic data pipeline, atomic checkpoints in the
reference's layout (gathered from and cut to any mesh), straggler
monitoring and restartable loops; the ``Trainer`` with or without a
mesh."""

from .checkpoint import latest_step, restore, save
from .data import DataConfig, DataPipeline
from .fault import (FaultInjector, RecoveryDecision, RecoveryPlanner,
                    RescheduleRequested, RestartableLoop, RestartPolicy,
                    StragglerConfig, StragglerMonitor)
from .optimizer import AdamState, AdamWConfig, adamw_update, init_adamw
from .compression import compress_pod_mean, init_error_buffers
from .trainer import Layout, TrainConfig, Trainer, make_train_step
