"""Roofline terms of a traced step, for the H100.

The counterpart of ``repro.launch.roofline``. Per (arch x shape x mesh)
cell, the three roofline terms of one rank's step, from its trace on the
meta device (``launch.steps.lower_*``, ``launch.step_trace``):

  compute term    = FLOPs_per_device / peak_FLOPs_per_chip
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

The trace is one rank's, so its FLOPs, bytes and collective bytes are
per device already. The analytic half (:class:`RooflineTerms`,
:func:`active_param_count`, :func:`model_memory_bytes`,
:func:`_cache_bytes`, :func:`model_flops`) is copied from the reference
unchanged but for the constants, which are the H100 SXM5's, not the TPU
v5e's.

The reference's ``shape_bytes`` and ``parse_collective_bytes`` parse
XLA's HLO text, which the port has none of; they are not carried over.
The collectives' operand bytes are recorded where the port issues them
(``launch.mesh.collective_bytes``, keyed by the same op kinds), and
:func:`extract_terms` reads them from the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

# NVIDIA H100 SXM5 (80 GB HBM3)
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s (NVIDIA H100 datasheet)
HBM_BW = 3.35e12          # bytes/s of HBM3 (NVIDIA H100 datasheet)
LINK_BW = 50e9            # bytes/s: one 400 Gb/s NDR InfiniBand port a GPU,
#                           as in a DGX H100; a 16-wide axis spans two
#                           8-GPU nodes, so its ring crosses that port


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def extract_terms(trace, chips: int) -> Tuple[RooflineTerms,
                                             Dict[str, Any]]:
    """(the terms, the collectives) of a traced step
    (``launch.step_trace.StepTrace``, one rank's)."""
    coll = trace.collectives
    return RooflineTerms(
        flops_per_device=float(trace.flops),
        bytes_per_device=float(trace.bytes_accessed),
        collective_bytes_per_device=float(coll["total_bytes"]),
        chips=chips,
    ), coll


# ---------------------------------------------------------------------------
# model FLOPs (the "useful work" yardstick)
# ---------------------------------------------------------------------------


def active_param_count(cfg) -> Tuple[int, int]:
    """(total, active) parameter counts from the config arithmetic."""
    D = cfg.d_model
    V = cfg.padded_vocab()
    H = cfg.padded_heads()
    KV = cfg.padded_kv_heads()
    Dh = cfg.resolved_head_dim()

    def attn_params() -> int:
        if cfg.attn_type == "mla":
            m = cfg.mla
            dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
            p = D * (m.kv_lora_rank + dr) + m.kv_lora_rank * H * (dn + dv)
            if m.q_lora_rank > 0:
                p += D * m.q_lora_rank + m.q_lora_rank * H * (dn + dr)
            else:
                p += D * H * (dn + dr)
            p += H * dv * D
            return p
        if cfg.attn_type == "none":
            # rwkv tmix: 5 square-ish projections + lora
            return 5 * D * D + D * (5 * 32) + 64 * D + D * 64
        return D * H * Dh + 2 * D * KV * Dh + H * Dh * D

    def mamba_params() -> int:
        s = cfg.ssm
        Din = s.expand * D
        N = s.d_state
        r = s.dt_rank or max(1, D // 16)
        return D * 2 * Din + s.d_conv * Din + Din * (r + 2 * N) + r * Din \
            + Din * N + Din * D

    def dense_mlp(F) -> int:
        return 3 * D * F if cfg.act == "swiglu" else 2 * D * F

    total = V * D                                     # embed
    if not cfg.tie_embeddings:
        total += D * V                                # head
    active = total

    n_layers = cfg.num_layers + cfg.num_encoder_layers
    for i in range(cfg.num_layers):
        if cfg.is_attention_layer(i):
            a = attn_params()
        elif cfg.ssm and cfg.ssm.kind == "rwkv6":
            a = attn_params()
        else:
            a = mamba_params()
        total += a
        active += a
        if cfg.ssm and cfg.ssm.kind == "rwkv6":
            m_tot = m_act = D * cfg.d_ff + cfg.d_ff * D + D * D
        elif cfg.is_moe_layer(i):
            mo = cfg.moe
            per = dense_mlp(mo.d_ff_expert)
            m_tot = mo.num_experts * per + D * mo.num_experts
            m_act = mo.num_experts_per_tok * per
            if mo.num_shared_experts:
                sh = dense_mlp(mo.d_ff_expert * mo.num_shared_experts)
                m_tot += sh
                m_act += sh
        else:
            F = cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.d_ff_dense
                                       and i < cfg.moe.first_k_dense) \
                else cfg.d_ff
            m_tot = m_act = dense_mlp(F)
        total += m_tot
        active += m_act
    for _ in range(cfg.num_encoder_layers):
        a = attn_params() + dense_mlp(cfg.d_ff)
        total += a
        active += a
    del n_layers
    return total, active


def model_memory_bytes(cfg, shape, *, chips: int, dp: int, tp: int,
                       zero1: bool = True) -> Dict[str, float]:
    """First-order *fused* HBM-traffic model per device per step.

    The HLO 'bytes accessed' metric sums every instruction's operands —
    an unfused upper bound (the TPU compiler fuses elementwise chains, so
    real traffic sits far below it). This model is the matching lower
    bound: every weight/activation/cache byte streamed the minimal number
    of times. Real machines land between the two, near this bound.

      weights  : params/tp, read 1x fwd (+2x bwd, +1x remat fwd for train),
                 written 1x by the optimizer (train).
      opt state: m+v fp32 read+write (train), ZeRO-sharded over dp.
      acts     : ~12 activation tensors of B*S*D bf16 per layer, written
                 fwd + read bwd (remat recomputes instead of storing all:
                 keep 2 residual streams stored, rest recomputed).
      cache    : decode reads the full KV/state cache per token.
      logits   : B*S*V fp32 write+read for the loss (train/prefill).
    """
    total, active = active_param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        S = S // 2
    D = cfg.d_model
    L = cfg.num_layers + cfg.num_encoder_layers
    Vp = cfg.padded_vocab()
    bpd = max(B // dp, 1)                        # batch per device
    w_bytes = 2 * total / tp                     # bf16 weights per device

    out: Dict[str, float] = {}
    if shape.kind == "train":
        out["weights"] = w_bytes * 4             # fwd + bwd(2) + remat fwd
        opt = (total / tp) * 4 * 2               # m+v fp32
        if zero1:
            opt /= dp
        out["opt_state"] = opt * 2 + (total / tp) * 4   # r+w, + p write
        # stored activations: 2 residual streams per layer + recompute
        out["activations"] = 2 * (bpd * S * D * 2) * L * 2
        out["logits"] = bpd * S * Vp * 4 * 2
    elif shape.kind == "prefill":
        out["weights"] = w_bytes
        out["activations"] = 2 * (bpd * S * D * 2) * L
        out["kv_write"] = _cache_bytes(cfg, bpd, S)
        out["logits"] = bpd * Vp * 4
    else:                                        # decode: one token
        out["weights"] = 2 * active / tp         # active params only
        out["cache_read"] = _cache_bytes(cfg, bpd, S)
        out["logits"] = bpd * Vp * 4
    out["total"] = sum(out.values())
    return out


def _cache_bytes(cfg, bpd: int, S: int) -> float:
    """Per-device KV/state cache size in bytes (read once per decode)."""
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        H, K = cfg.num_heads, cfg.ssm.head_dim
        return cfg.num_layers * bpd * (H * K * K * 4 + cfg.d_model * 2)
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.is_attention_layer(i) and cfg.attn_type != "none")
    n_ssm = cfg.num_layers - n_attn
    S_eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
    if cfg.attn_type == "mla":
        m = cfg.mla
        per = bpd * S_eff * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
    else:
        per = bpd * S_eff * cfg.padded_kv_heads() * \
            cfg.resolved_head_dim() * 2 * 2
    total = n_attn * per
    if n_ssm and cfg.ssm is not None:
        Din = cfg.ssm.expand * cfg.d_model
        total += n_ssm * bpd * (Din * cfg.ssm.d_state * 4 +
                                (cfg.ssm.d_conv - 1) * Din * 2)
    return total


def model_flops(cfg, shape) -> float:
    """6*N_active*T for training, 2*N_active*T for inference forward, plus
    the quadratic attention term where applicable."""
    total, active = active_param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encoder_decoder:
        S = S // 2
    H = cfg.padded_heads()
    Dh = cfg.resolved_head_dim()
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.is_attention_layer(i) and cfg.attn_type != "none")
    if shape.kind == "train":
        toks = B * S
        attn = 2 * 2 * toks * S * H * Dh * n_attn * 0.5 * 3   # fwd+bwd, causal
        return 6.0 * active * toks + attn
    if shape.kind == "prefill":
        toks = B * S
        attn = 2 * 2 * toks * S * H * Dh * n_attn * 0.5
        return 2.0 * active * toks + attn
    # decode: one token per sequence; attention reads the full cache
    toks = B
    window = cfg.sliding_window if cfg.sliding_window else S
    attn = 2 * 2 * toks * min(window, S) * H * Dh * n_attn
    return 2.0 * active * toks + attn
