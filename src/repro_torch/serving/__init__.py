"""Model-guided serving: continuous batching, paged KV blocks, replay.

Layers (each importable on its own):

* :mod:`.engine` — one-call ``Engine.generate`` facade (the model's
  module where the reference passes a parameter tree),
* :mod:`.scheduler` — continuous-batching ``Scheduler`` + backends,
* :mod:`.kvblocks` — paged KV-cache ``BlockManager``,
* :mod:`.cost` — per-step serving cost model + telemetry refit,
* :mod:`.policy` — FIFO vs model-guided batch composition,
* :mod:`.trace` — synthetic traces and policy-comparison replay.
"""

from .cost import (ServeCostModel, ServeScales, ServeStepCost, cost_model_for,
                   install_scales, predict_serve_step, refit_serving)
from .engine import Engine, ServeConfig, make_serve_step
from .kvblocks import BlockCapacityError, BlockManager, blocks_for
from .policy import (DegradationController, FIFOPolicy, ModelGuidedPolicy,
                     Policy, StepPlan, make_policy)
from .scheduler import (ModelBackend, Request, Scheduler, SchedulerConfig,
                        SimBackend, build_scheduler)
from .trace import (ReplayReport, TraceConfig, compare_policies, replay,
                    replay_for, replay_traced, synthesize_trace)
