"""Beyond-paper: the paper's methodology applied to LM train/serve steps.

Exactly as §IV prescribes for linear algebra, we walk the step's execution
flow, charging ``T_rout`` for each local matmul (MXU efficiency curve at
the operand's blocking) and the calibrated alpha-beta collective models for
every mesh collective the sharding implies:

  per layer (Megatron TP over 'model', DP over 'data'/'pod'):
    fwd: 2 ring all-reduces of the (B_local, S, D) activations over TP
    bwd: 2 more + weight-gradient compute
    (FSDP: + per-layer all-gather of the layer's params over 'data')
  per step:
    DP gradient reduce-scatter + all-gather (ring) over 'data'
    cross-pod gradient all-reduce over 'pod' (DCN beta), optionally int8
  MoE: all-to-all dispatch/return over the expert axis, top_k-scaled FFN

The result is the same three-term structure as §Roofline but derived from
the *model*, not the compiled HLO — EXPERIMENTS.md cross-checks the two
(model collective bytes vs HLO-parsed collective bytes), which is this
framework's analog of the paper's Fig. 5-8 est-vs-measured validation.

C_avg/C_max enter exactly as in the paper: every collective is a
synchronization, so sync-closing steps take C_max(p, d); the torus
link-load simulator supplies the surfaces for hardware we cannot measure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from ..configs.base import ModelConfig, ShapeConfig
from ..sim import derive_calibration, v5e_pod_topology
from .collectives import t_all_to_all, t_ring_allgather, t_ring_allreduce, \
    t_ring_reducescatter
from .machine import TPU_V5E, Machine
from .perfmodel import (Calibration, CommModel, ComputeModel,
                        IdentityCalibration, TPU_EFFICIENCY)


@dataclasses.dataclass
class LMStepEstimate:
    compute_s: float
    tp_collective_s: float
    dp_collective_s: float
    pod_collective_s: float
    moe_alltoall_s: float
    flops_per_chip: float
    collective_bytes_per_chip: float

    @property
    def collective_s(self) -> float:
        return (self.tp_collective_s + self.dp_collective_s
                + self.pod_collective_s + self.moe_alltoall_s)

    @property
    def total_overlapped(self) -> float:
        """Paper overlap composition: collectives hidden behind compute."""
        return max(self.compute_s, self.collective_s)

    @property
    def total_serial(self) -> float:
        return self.compute_s + self.collective_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(collective_s=self.collective_s,
                 total_overlapped=self.total_overlapped,
                 total_serial=self.total_serial)
        return d


def predict_train_step(cfg: ModelConfig, shape: ShapeConfig,
                       mesh_shape: Dict[str, int],
                       machine: Machine = TPU_V5E,
                       calibration: Optional[Calibration] = None,
                       *, fsdp: bool = False,
                       int8_pod_reduce: bool = False) -> LMStepEstimate:
    cal = calibration or derive_calibration(
        v5e_pod_topology(), ps=[16, 64, 256], distances=[1, 2, 4, 8])
    cm = CommModel(machine, cal)
    comp = ComputeModel(machine, TPU_EFFICIENCY)

    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1)
    pods = mesh_shape.get("pod", 1)
    chips = tp * dp * pods
    B, S, D, L = shape.global_batch, shape.seq_len, cfg.d_model, cfg.n_layers
    tokens = B * S
    words = lambda n_bytes: n_bytes / machine.word_bytes

    # ---- compute term: 6 * active-params * tokens, at matmul efficiency of
    # the per-chip blocking (the MXU sees [tokens/dp x D/tp]-ish tiles)
    flops = 6.0 * cfg.active_param_count() * tokens
    block = min(tokens / (dp * pods), max(cfg.d_ff, cfg.d_model) / tp)
    eff = comp.efficiency["dgemm"](block)
    compute_s = flops / (chips * machine.peak_flops_per_unit * eff)
    # remat forward recompute: +fwd pass (1/3 of 6ND)
    if cfg.remat:
        compute_s *= 4.0 / 3.0

    # ---- TP collectives: 4 all-reduces of local activations per layer
    # (2 fwd + 2 bwd), ring over the model axis, every one a sync (C_max)
    act_bytes = (tokens / (dp * pods)) * D * 2
    tp_one = t_ring_allreduce(cm, tp, words(act_bytes), d=1)
    tp_s = 4 * L * tp_one * (cal.c_max(chips, 1) / max(cal.c_avg(1), 1e-9))

    # ---- FSDP per-layer param all-gather (fwd + bwd) over 'data'
    fsdp_s = 0.0
    param_bytes = cfg.param_count() * 2
    if fsdp:
        per_layer = param_bytes / max(L, 1) / tp
        fsdp_s = 2 * L * t_ring_allgather(cm, dp, words(per_layer), d=1)

    # ---- DP gradient reduce-scatter + all-gather over 'data'
    grad_bytes = param_bytes / tp
    dp_s = (t_ring_reducescatter(cm, dp, words(grad_bytes), d=1)
            + t_ring_allgather(cm, dp, words(grad_bytes), d=1)) if dp > 1 else 0.0
    dp_s += fsdp_s

    # ---- cross-pod gradient all-reduce over DCN
    pod_s = 0.0
    if pods > 1:
        dcn = machine.dcn_bandwidth or machine.link_bandwidth
        shard = grad_bytes / dp
        factor = 1.0 if int8_pod_reduce else 2.0   # int8 AG vs bf16 ring AR
        pod_s = factor * shard * (pods - 1) / pods / dcn
        pod_s *= cal.c_max(chips, 1) / max(cal.c_avg(1), 1e-9)

    # ---- MoE all-to-all (dispatch + return, fwd + bwd)
    moe_s = 0.0
    routed_bytes = 0.0
    if cfg.moe:
        routed_bytes = tokens / (dp * pods) * D * 2 * cfg.moe.top_k
        moe_s = 4 * t_all_to_all(cm, tp, words(routed_bytes), d=1)

    coll_bytes = (4 * L * act_bytes * 2 * (tp - 1) / tp
                  + 2 * grad_bytes
                  + (routed_bytes * 4 if cfg.moe else 0.0))
    return LMStepEstimate(
        compute_s=compute_s, tp_collective_s=tp_s, dp_collective_s=dp_s,
        pod_collective_s=pod_s, moe_alltoall_s=moe_s,
        flops_per_chip=flops / chips,
        collective_bytes_per_chip=coll_bytes / chips)


def sharding_tradeoff_table(cfg: ModelConfig, shape: ShapeConfig,
                            chips: int = 256,
                            machine: Machine = TPU_V5E) -> Dict[str, dict]:
    """The paper's Tables II-V analog for LM training: sweep the (dp, tp)
    factorization (and FSDP on/off — the 2.5D-style memory-for-comm trade)
    and report predicted step time per configuration."""
    out = {}
    tp = 1
    while tp <= chips:
        dp = chips // tp
        if dp * tp == chips and dp >= 1:
            for fsdp in (False, True):
                est = predict_train_step(cfg, shape,
                                         {"data": dp, "model": tp},
                                         machine, fsdp=fsdp)
                mem_gb = (cfg.param_count() * 2 *
                          (1.0 / tp if not fsdp else 1.0 / (tp * dp))) / 1e9
                out[f"dp{dp}xtp{tp}{'+fsdp' if fsdp else ''}"] = {
                    "step_s": est.total_overlapped,
                    "compute_s": est.compute_s,
                    "collective_s": est.collective_s,
                    "param_gb_per_chip": mem_gb,
                }
        tp *= 2
    return out
