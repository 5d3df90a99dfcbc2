"""Roofline terms of a dry-run step on NVIDIA H100 SXM5 80GB cards.

    compute    = FLOPs / peak_FLOPs            (per device)
    memory     = HBM_bytes / HBM_bw            (per device)
    collective = collective_bytes / link_bw    (per device)

FLOPs and HBM bytes come from ``core.profiler.profile_torch``, which reads
one step traced on fake tensors (every layer and recompute runs, so no
loop correction is needed).  The placement-aware term decomposes every
collective over the H100 fabric (:class:`~repro_torch.core.placement.
GpuFabric`) under {linear, tofa} rank orders: the paper's objective
surfaced as a roofline quantity.  The arithmetic is the reference's
(``repro.launch.roofline``); only the card's constants differ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# NVIDIA H100 SXM5 80GB data sheet, per GPU, at its 700 W limit: dense
# bfloat16 tensor-core peak, HBM3 bandwidth, NVLink 4 per direction,
# NDR InfiniBand per GPU (400 Gb/s; the fabric's inter-node links only),
# and HBM capacity.
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9
IB_BW = 50e9
HBM_BYTES = 80e9


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops: float                 # per device, every layer traced
    bytes_accessed: float        # per device
    collective_bytes: float      # per device
    model_flops: float           # 6ND (train) / 2ND (fwd) per device
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time bound: the max term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak the step would hit: useful compute time over
        the bounding term."""
        bound = self.step_s
        return (self.model_flops / self.peak_flops) / bound if bound else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "devices": self.n_devices,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape_cfg, n_devices: int) -> float:
    """Per-device MODEL_FLOPS: 6·N·D for training, 2·N·D forward-only,
    2·N_active·B for one decode step (D = tokens processed)."""
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        total = 6.0 * cfg.n_active_params * tokens
    elif shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        total = 2.0 * cfg.n_active_params * tokens
    else:  # decode: one token per sequence
        total = 2.0 * cfg.n_active_params * shape_cfg.global_batch
    return total / n_devices


def ideal_attention_bytes(cfg, shape_cfg, batch_per_dev: float,
                          heads_per_dev: float) -> float:
    """Per-device HBM bytes of the flash/SSD kernels for one step.

    The plain online-softmax version writes its block intermediates to
    HBM (the profiler tags that traffic 'flash'/'ssd'); the kernels keep
    them on chip, touching only q/k/v/o (+ O(S) stats):

      fwd:        (q + k + v + o)           = 4*T*Dh per head
      remat fwd:  + 4*T*Dh
      bwd:        reads q,k,v,dout + writes dq,dk,dv  ~ 8*T*Dh

    -> 16*T*Dh per head per layer for training, 4 for inference.  SSM archs
    use the analogous xdt/dA/B/C/y (+state) ~ 6*T*P per head.
    """
    S = shape_cfg.seq_len if shape_cfg.kind != "decode" else 1
    T = batch_per_dev * S
    dtype_bytes = 2.0
    passes = 16.0 if shape_cfg.kind == "train" else 4.0
    if cfg.family in ("ssm", "hybrid") and cfg.ssm:
        d_in = cfg.ssm.expand * cfg.d_model
        per_layer = passes / 16 * 6 * T * d_in * dtype_bytes
        n_layers = cfg.n_layers
        attn_layers = (cfg.n_layers // (cfg.hybrid_every or 6)
                       if cfg.family == "hybrid" else 0)
        attn = passes * T * cfg.head_dim_ * heads_per_dev * dtype_bytes \
            * attn_layers
        return per_layer * n_layers + attn
    hd = cfg.head_dim_
    n_attn = cfg.n_layers + (cfg.n_enc_layers or 0)
    return passes * T * hd * heads_per_dev * dtype_bytes * n_attn


def production_fabric(n_devices: int):
    """The H100 fabric of a production mesh: ``n_devices`` GPUs, 8 to a
    node, the nodes on an InfiniBand fat tree (``LINK_BW / IB_BW`` a
    hop)."""
    from repro_torch.core.placement import GpuFabric
    return GpuFabric(n_gpus=n_devices, ib_hop_cost=LINK_BW / IB_BW)


def placement_terms(profile, multi_pod: bool, policies=("linear", "tofa"),
                    p_f: np.ndarray | None = None, device=None) -> dict:
    """Hop-weighted collective cost per placement policy (paper tie-in),
    on the H100 fabric of the production mesh (256 GPUs, or 512 with
    ``multi_pod``), placed by the default engine on ``device`` (``cuda``
    when omitted)."""
    from repro_torch.core.placement import compare_policies
    from repro_torch.core.profiler import comm_graph_from_profile

    n = profile.num_partitions
    fabric = production_fabric(512 if multi_pod else 256)
    if fabric.n_nodes != n:
        return {}
    comm = comm_graph_from_profile(profile)
    return compare_policies(comm, fabric, policies=policies, p_f=p_f,
                            device=device)
