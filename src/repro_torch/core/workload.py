"""Kernel-sequence decomposition of one training/serving iteration.

This is the paper's unit of analysis: Table 1 lists the 46 kernels of one
GPT-3-xl iteration (llm.c decomposition: GEMM / Permute / Softmax /
Residual / GELU / Layernorm / Bias / embedding ± backward).  We generate the
same decomposition analytically from a :class:`ModelConfig` +
:class:`ShapeConfig` — with exact FLOPs and HBM bytes per kernel — and
extend it to every assigned architecture family (MoE dispatch, SSD scans,
cross-attention, decode GEMV/cache-read kernels) plus optional tensor/
sequence parallelism (§8; communication excluded by default, exactly as the
paper's Megatron-style extension of llm.c does) and optimizer kernels
(beyond-paper).

The port's copy of the JAX package's ``core/workload.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..configs.base import ModelConfig, ShapeConfig
from .power_model import KernelSpec


def _ceil_div(a, b):
    return -(-a // b)


def _kv_dtype_bytes(kv_dtype: Optional[str], dtype_bytes: int) -> int:
    """Stored bytes per paged-KV element.  Mirrors
    :func:`repro.serve.kv_pages.kv_dtype_bytes` without importing the
    serve layer (core must stay importable without it)."""
    if kv_dtype in (None, "none", "bf16", "fp16", "float32"):
        return dtype_bytes
    if kv_dtype in ("int8", "fp8_e4m3"):
        return 1
    raise ValueError(f"unknown kv_dtype {kv_dtype!r}")


class WorkloadBuilder:
    """Builds the ordered kernel list for one iteration of (cfg, shape)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *,
                 dtype_bytes: int = 2, tp: int = 1, sp: bool = False,
                 dp: int = 1, include_comm: bool = False,
                 include_optimizer: bool = False,
                 batch_override: Optional[int] = None,
                 kv_dtype: Optional[str] = None):
        self.cfg = cfg
        self.shape = shape
        self.db = dtype_bytes
        # bytes per *stored* paged-KV element: a quantized serve cache
        # (int8/fp8 page pools) halves the decode cache-read stream while
        # activations/weights stay at dtype_bytes — the decode roofline
        # shift the planner must see.  Dense cross-attention K/V (encdec)
        # is not paged and stays at dtype_bytes.
        self.kv_db = _kv_dtype_bytes(kv_dtype, dtype_bytes)
        self.kv_dtype = kv_dtype or "none"
        self.tp = max(tp, 1)
        self.sp = sp
        self.include_comm = include_comm
        self.include_optimizer = include_optimizer
        self.B = batch_override if batch_override is not None \
            else max(shape.global_batch // max(dp, 1), 1)
        self.S = shape.seq_len
        self.kernels: List[KernelSpec] = []

    # -- emit helpers -----------------------------------------------------
    def _emit(self, name, kind, flops, hbm, ici=0.0, inv=1, phase="fwd"):
        self.kernels.append(KernelSpec(
            name=name, kind=kind, flops=float(max(flops, 0.0)),
            hbm_bytes=float(max(hbm, 1.0)), ici_bytes=float(ici),
            invocations=int(inv), phase=phase))

    # Large GEMMs stream their input panels more than once (tiling re-reads
    # through L2); effective HBM traffic is reuse*(A+B panels) + C.
    GEMM_PANEL_REUSE = 4.0

    def _gemm(self, name, M, N, K, inv=1, phase="fwd"):
        reuse = self.GEMM_PANEL_REUSE if min(M, N, K) >= 512 else \
            (2.0 if min(M, N, K) >= 128 else 1.0)
        self._emit(name, "gemm", 2.0 * M * N * K,
                   self.db * (reuse * (M * K + K * N) + M * N),
                   inv=inv, phase=phase)

    def _gemm_bwd(self, name, M, N, K, inv=1):
        # dgrad: dX = dY @ W^T ; wgrad: dW = X^T @ dY
        self._gemm(f"{name} dgrad", M, K, N, inv=inv, phase="bwd")
        self._gemm(f"{name} wgrad", K, N, M, inv=inv, phase="bwd")

    def _elem(self, name, kind, elems, rw=3, flops_per=1.0, inv=1,
              phase="fwd"):
        self._emit(name, kind, flops_per * elems, rw * self.db * elems,
                   inv=inv, phase=phase)

    # -- family decompositions ---------------------------------------------
    def _seq_elems(self):
        """Elements of one (B, S, d) activation after sequence parallelism."""
        div = self.tp if self.sp else 1
        return self.B * self.S * self.cfg.d_model / div

    def _attention_fwd(self, prefix, S_kv=None, causal=True, inv=1,
                       d_in=None, d_out=None, window=0):
        cfg = self.cfg
        B, S, db = self.B, self.S, self.db
        d_in = d_in or cfg.d_model
        d_out = d_out or cfg.d_model
        H = max(cfg.n_heads // self.tp, 1)
        KVh = max(cfg.n_kv_heads // self.tp, 1)
        hd = cfg.resolved_head_dim or (d_in // max(cfg.n_heads, 1))
        S_kv = S_kv or S
        eff_kv = min(window, S_kv) if window else S_kv
        frac = 0.5 if (causal and not window and S == S_kv) else 1.0
        self._gemm(f"{prefix}GEMM qkv", B * S, (H + 2 * KVh) * hd, d_in,
                   inv=inv)
        if cfg.positional == "rope":
            self._elem(f"{prefix}RoPE", "permute",
                       B * S * (H + KVh) * hd, rw=2, inv=inv)
        self._elem(f"{prefix}Permute", "permute", B * S * H * hd, rw=2,
                   inv=inv)
        score_elems = B * H * S * eff_kv * frac
        panel = self.GEMM_PANEL_REUSE
        self._emit(f"{prefix}GEMM qk", "gemm", 2 * score_elems * hd,
                   db * (panel * (B * S * H * hd + B * eff_kv * KVh * hd)
                         + score_elems), inv=inv)
        self._elem(f"{prefix}Softmax", "softmax", score_elems, rw=2, inv=inv,
                   flops_per=4.0)
        self._emit(f"{prefix}GEMM av", "gemm", 2 * score_elems * hd,
                   db * (score_elems + panel * B * eff_kv * KVh * hd
                         + B * S * H * hd), inv=inv)
        self._elem(f"{prefix}Unpermute", "permute", B * S * H * hd, rw=2,
                   inv=inv)
        self._gemm(f"{prefix}GEMM proj", B * S, d_out, H * hd, inv=inv)
        if self.include_comm and self.tp > 1:
            self._emit(f"{prefix}AllReduce attn", "allreduce", 0,
                       db * B * S * d_out / 4,
                       ici=2 * db * B * S * d_out * (self.tp - 1) / self.tp,
                       inv=inv)

    def _attention_bwd(self, prefix, S_kv=None, causal=True, inv=1,
                       d_in=None, d_out=None, window=0):
        cfg = self.cfg
        B, S, db = self.B, self.S, self.db
        d_in = d_in or cfg.d_model
        d_out = d_out or cfg.d_model
        H = max(cfg.n_heads // self.tp, 1)
        KVh = max(cfg.n_kv_heads // self.tp, 1)
        hd = cfg.resolved_head_dim or (d_in // max(cfg.n_heads, 1))
        S_kv = S_kv or S
        eff_kv = min(window, S_kv) if window else S_kv
        frac = 0.5 if (causal and not window and S == S_kv) else 1.0
        score_elems = B * H * S * eff_kv * frac
        panel = self.GEMM_PANEL_REUSE
        self._gemm_bwd(f"{prefix}GEMM proj", B * S, d_out, H * hd, inv=inv)
        self._elem(f"{prefix}Permute bwd", "permute", B * S * H * hd, rw=2,
                   inv=inv, phase="bwd")
        # d(av): dP = dO V^T ; dV = P^T dO
        self._emit(f"{prefix}GEMM av dgrad", "gemm", 2 * score_elems * hd,
                   db * (panel * (B * S * H * hd + B * eff_kv * KVh * hd)
                         + score_elems), inv=inv, phase="bwd")
        self._emit(f"{prefix}GEMM av wgrad", "gemm", 2 * score_elems * hd,
                   db * (score_elems + panel * B * S * H * hd
                         + B * eff_kv * KVh * hd), inv=inv, phase="bwd")
        self._elem(f"{prefix}Softmax bwd", "softmax", score_elems, rw=3,
                   inv=inv, phase="bwd", flops_per=4.0)
        self._emit(f"{prefix}GEMM qk dgrad", "gemm", 2 * score_elems * hd,
                   db * (score_elems + panel * B * eff_kv * KVh * hd
                         + B * S * H * hd), inv=inv, phase="bwd")
        self._emit(f"{prefix}GEMM qk wgrad", "gemm", 2 * score_elems * hd,
                   db * (score_elems + panel * B * S * H * hd
                         + B * eff_kv * KVh * hd), inv=inv, phase="bwd")
        self._gemm_bwd(f"{prefix}GEMM qkv", B * S, (H + 2 * KVh) * hd, d_in,
                       inv=inv)

    def _mlp_fwd(self, prefix, inv=1, d_in=None):
        cfg = self.cfg
        B, S = self.B, self.S
        d_in = d_in or cfg.d_model
        ff = max(cfg.d_ff // self.tp, 1)
        n_up = 2 if cfg.activation == "swiglu" else 1
        self._gemm(f"{prefix}GEMM mlp up", B * S, n_up * ff, d_in, inv=inv)
        act = {"swiglu": "gelu", "gelu": "gelu", "relu2": "gelu"}
        self._elem(f"{prefix}{cfg.activation.upper()}", act[cfg.activation],
                   B * S * ff, rw=2 + (n_up - 1), inv=inv, flops_per=6.0)
        self._gemm(f"{prefix}GEMM mlp down", B * S, cfg.d_model, ff, inv=inv)
        if self.include_comm and self.tp > 1:
            self._emit(f"{prefix}AllReduce mlp", "allreduce", 0,
                       self.db * B * S * cfg.d_model / 4,
                       ici=2 * self.db * B * S * cfg.d_model
                       * (self.tp - 1) / self.tp, inv=inv)

    def _mlp_bwd(self, prefix, inv=1, d_in=None):
        cfg = self.cfg
        B, S = self.B, self.S
        d_in = d_in or cfg.d_model
        ff = max(cfg.d_ff // self.tp, 1)
        n_up = 2 if cfg.activation == "swiglu" else 1
        self._gemm_bwd(f"{prefix}GEMM mlp down", B * S, cfg.d_model, ff,
                       inv=inv)
        self._elem(f"{prefix}{cfg.activation.upper()} bwd", "gelu",
                   B * S * ff, rw=3, inv=inv, phase="bwd", flops_per=8.0)
        self._gemm_bwd(f"{prefix}GEMM mlp up", B * S, n_up * ff, d_in,
                       inv=inv)

    def _moe_fwd(self, prefix, inv=1):
        cfg = self.cfg
        B, S, db = self.B, self.S, self.db
        d = cfg.d_model
        T = B * S
        E = cfg.moe.n_experts
        K = cfg.moe.top_k
        ep = min(self.tp, E)
        ff = cfg.d_ff
        n_up = 2 if cfg.activation == "swiglu" else 1
        self._gemm(f"{prefix}GEMM router", T, E, d, inv=inv)
        self._elem(f"{prefix}Softmax+topk", "softmax", T * E, rw=2, inv=inv,
                   flops_per=6.0)
        self._elem(f"{prefix}Dispatch scatter", "dispatch", T * K * d / ep,
                   rw=2, inv=inv)
        if self.include_comm and ep > 1:
            self._emit(f"{prefix}AllToAll dispatch", "alltoall", 0,
                       db * T * K * d / ep,
                       ici=db * T * K * d * (ep - 1) / ep, inv=inv)
        Te = T * K / ep  # tokens per EP shard
        self._gemm(f"{prefix}GEMM experts up", Te, n_up * ff, d, inv=inv)
        self._elem(f"{prefix}{cfg.activation.upper()} experts", "gelu",
                   Te * ff, rw=2 + (n_up - 1), inv=inv, flops_per=6.0)
        self._gemm(f"{prefix}GEMM experts down", Te, d, ff, inv=inv)
        if self.include_comm and ep > 1:
            self._emit(f"{prefix}AllToAll combine", "alltoall", 0,
                       db * T * K * d / ep,
                       ici=db * T * K * d * (ep - 1) / ep, inv=inv)
        self._elem(f"{prefix}Combine gather", "dispatch", T * K * d / ep,
                   rw=2, inv=inv)
        if cfg.moe.shared_expert:
            self._gemm(f"{prefix}GEMM shared up", T, n_up * ff // self.tp,
                       d, inv=inv)
            self._elem(f"{prefix}Act shared", "gelu", T * ff // self.tp,
                       rw=2, inv=inv, flops_per=6.0)
            self._gemm(f"{prefix}GEMM shared down", T, d, ff // self.tp,
                       inv=inv)

    def _moe_bwd(self, prefix, inv=1):
        cfg = self.cfg
        T = self.B * self.S
        E, K = cfg.moe.n_experts, cfg.moe.top_k
        ep = min(self.tp, E)
        ff, d = cfg.d_ff, cfg.d_model
        n_up = 2 if cfg.activation == "swiglu" else 1
        Te = T * K / ep
        self._elem(f"{prefix}Combine bwd", "dispatch", T * K * d / ep, rw=2,
                   inv=inv, phase="bwd")
        self._gemm_bwd(f"{prefix}GEMM experts down", Te, d, ff, inv=inv)
        self._elem(f"{prefix}Act experts bwd", "gelu", Te * ff, rw=3,
                   inv=inv, phase="bwd", flops_per=8.0)
        self._gemm_bwd(f"{prefix}GEMM experts up", Te, n_up * ff, d, inv=inv)
        self._elem(f"{prefix}Dispatch bwd", "dispatch", T * K * d / ep, rw=2,
                   inv=inv, phase="bwd")
        self._gemm_bwd(f"{prefix}GEMM router", T, E, d, inv=inv)
        if cfg.moe.shared_expert:
            self._gemm_bwd(f"{prefix}GEMM shared down", T, d,
                           ff // self.tp, inv=inv)
            self._gemm_bwd(f"{prefix}GEMM shared up", T,
                           n_up * ff // self.tp, d, inv=inv)

    def _norm(self, name, inv=1, phase="fwd", d=None):
        elems = self.B * self.S * (d or self.cfg.d_model)
        if self.sp:
            elems /= self.tp
        self._elem(name, "layernorm", elems, rw=2 if phase == "fwd" else 4,
                   inv=inv, phase=phase, flops_per=6.0)

    def _residual(self, name, inv=1, phase="fwd"):
        elems = self._seq_elems()
        self._elem(name, "residual", elems, rw=3, inv=inv, phase=phase,
                   flops_per=1.0)

    def _ssm_fwd(self, prefix, inv=1):
        cfg = self.cfg
        s = cfg.ssm
        B, S, db = self.B, self.S, self.db
        d = cfg.d_model
        d_in = s.expand * d // self.tp
        nh = max(d_in // s.head_dim, 1)
        G, N, P = s.n_groups, s.state_dim, s.head_dim
        Q = s.chunk_size
        nc = _ceil_div(S, Q)
        conv_ch = d_in + 2 * G * N
        proj_out = 2 * d_in + 2 * G * N + nh
        self._gemm(f"{prefix}GEMM in_proj", B * S, proj_out, d, inv=inv)
        self._emit(f"{prefix}Conv1d", "conv",
                   2.0 * B * S * conv_ch * s.conv_width,
                   2 * db * B * S * conv_ch, inv=inv)
        # SSD intra-chunk dual form (CB^T, masked, @x)
        intra_flops = 2.0 * B * nc * G * Q * Q * N \
            + 2.0 * B * nc * nh * Q * Q * P
        self._emit(f"{prefix}SSD intra", "gemm", intra_flops,
                   db * (2 * B * S * G * N + B * S * nh * P
                         + B * nc * G * Q * Q), inv=inv)
        self._emit(f"{prefix}SSD state", "gemm",
                   2.0 * B * S * nh * N * P,
                   db * B * S * nh * P + 4 * B * nc * nh * N * P, inv=inv)
        self._emit(f"{prefix}SSD scan", "scan", B * nc * nh * N * P,
                   2 * 4 * B * nc * nh * N * P, inv=inv)
        self._emit(f"{prefix}SSD out", "gemm", 2.0 * B * S * nh * N * P,
                   db * (B * S * G * N + B * S * nh * P)
                   + 4 * B * nc * nh * N * P, inv=inv)
        self._elem(f"{prefix}GateNorm", "layernorm", B * S * d_in, rw=3,
                   inv=inv, flops_per=8.0)
        self._gemm(f"{prefix}GEMM out_proj", B * S, d, d_in, inv=inv)

    def _ssm_bwd(self, prefix, inv=1):
        cfg = self.cfg
        s = cfg.ssm
        B, S, db = self.B, self.S, self.db
        d = cfg.d_model
        d_in = s.expand * d // self.tp
        nh = max(d_in // s.head_dim, 1)
        G, N, P = s.n_groups, s.state_dim, s.head_dim
        Q = s.chunk_size
        nc = _ceil_div(S, Q)
        proj_out = 2 * d_in + 2 * G * N + nh
        self._gemm_bwd(f"{prefix}GEMM out_proj", B * S, d, d_in, inv=inv)
        self._elem(f"{prefix}GateNorm bwd", "layernorm", B * S * d_in, rw=4,
                   inv=inv, phase="bwd", flops_per=10.0)
        intra_flops = 2 * (2.0 * B * nc * G * Q * Q * N
                           + 2.0 * B * nc * nh * Q * Q * P)
        self._emit(f"{prefix}SSD bwd", "gemm",
                   intra_flops + 2 * 2.0 * B * S * nh * N * P,
                   2 * db * (2 * B * S * G * N + B * S * nh * P)
                   + 8 * B * nc * nh * N * P, inv=inv, phase="bwd")
        self._emit(f"{prefix}SSD scan bwd", "scan", B * nc * nh * N * P,
                   2 * 4 * B * nc * nh * N * P, inv=inv, phase="bwd")
        self._emit(f"{prefix}Conv1d bwd", "conv",
                   4.0 * B * S * (d_in + 2 * G * N) * s.conv_width,
                   4 * db * B * S * (d_in + 2 * G * N), inv=inv,
                   phase="bwd")
        self._gemm_bwd(f"{prefix}GEMM in_proj", B * S, proj_out, d, inv=inv)

    # -- loss --------------------------------------------------------------
    def _loss(self, include_bwd: bool):
        cfg = self.cfg
        B, S, db = self.B, self.S, self.db
        d = cfg.d_model
        V = max(cfg.vocab_size // self.tp, 1)
        self._norm("Layernorm final", phase="fwd")
        self._gemm("GEMM lm_head", B * S, V, d, phase="loss")
        self._elem("Softmax loss", "softmax", B * S * V, rw=2, phase="loss",
                   flops_per=5.0)
        if include_bwd:
            self._gemm("GEMM lm_head dgrad", B * S, d, V, phase="loss")
            self._gemm("GEMM lm_head wgrad", d, V, B * S, phase="loss")
            self._norm("Layernorm final bwd", phase="bwd")

    def _embedding(self, include_bwd: bool):
        cfg = self.cfg
        B, S, db = self.B, self.S, self.db
        self._emit("WTE & WPE", "embed", 0,
                   db * B * S * cfg.d_model + 4 * B * S, phase="embed")
        if include_bwd:
            if cfg.positional == "learned":
                self._emit("WPE bwd", "embed", 0,
                           db * B * S * cfg.d_model, phase="embed")
            self._emit("WTE bwd", "embed", 0,
                       2 * db * B * S * cfg.d_model, phase="embed")

    def _optimizer(self):
        total, _ = self.cfg.param_count()
        shard = total / max(self.tp, 1)
        # adamw: read p, m, v, g; write p, m, v (fp32 states)
        self._emit("AdamW update", "optimizer", 12.0 * shard,
                   4 * 7 * shard, phase="opt")

    # -- top-level families --------------------------------------------------
    def _dense_layer(self, include_bwd: bool):
        cfg = self.cfg
        L = cfg.n_layers
        if cfg.attn_window and cfg.global_attn_every:
            g = cfg.global_attn_every
            n_local = L * (g - 1) // g
            n_global = L // g
            layer_plans = [("local ", n_local, cfg.attn_window),
                           ("global ", n_global, 0)]
        else:
            layer_plans = [("", L, 0)]
        for prefix, inv, window in layer_plans:
            self._norm(f"{prefix}Layernorm attn", inv=inv)
            self._attention_fwd(prefix, inv=inv, window=window)
            self._residual(f"{prefix}Residual attn", inv=inv)
            self._norm(f"{prefix}Layernorm mlp", inv=inv)
            if cfg.is_moe:
                self._moe_fwd(prefix, inv=inv)
            else:
                self._mlp_fwd(prefix, inv=inv)
            self._residual(f"{prefix}Residual mlp", inv=inv)
        if include_bwd:
            for prefix, inv, window in layer_plans:
                self._residual(f"{prefix}Residual mlp bwd", inv=inv,
                               phase="bwd")
                if cfg.is_moe:
                    self._moe_bwd(prefix, inv=inv)
                else:
                    self._mlp_bwd(prefix, inv=inv)
                self._norm(f"{prefix}Layernorm mlp bwd", inv=inv,
                           phase="bwd")
                self._residual(f"{prefix}Residual attn bwd", inv=inv,
                               phase="bwd")
                self._attention_bwd(prefix, inv=inv, window=window)
                self._norm(f"{prefix}Layernorm attn bwd", inv=inv,
                           phase="bwd")

    def _encdec_layers(self, include_bwd: bool):
        cfg = self.cfg
        F = cfg.encoder_frontend_len
        # encoder (bidirectional, length F)
        S_save = self.S
        self.S = F
        self._norm("enc Layernorm", inv=cfg.n_encoder_layers)
        self._attention_fwd("enc ", causal=False,
                            inv=cfg.n_encoder_layers)
        self._mlp_fwd("enc ", inv=cfg.n_encoder_layers)
        self._residual("enc Residual", inv=2 * cfg.n_encoder_layers)
        if include_bwd:
            self._attention_bwd("enc ", causal=False,
                                inv=cfg.n_encoder_layers)
            self._mlp_bwd("enc ", inv=cfg.n_encoder_layers)
        self.S = S_save
        # decoder
        self._norm("dec Layernorm", inv=2 * cfg.n_layers)
        self._attention_fwd("dec self ", inv=cfg.n_layers)
        self._attention_fwd("dec cross ", S_kv=F, causal=False,
                            inv=cfg.n_layers)
        self._mlp_fwd("dec ", inv=cfg.n_layers)
        self._residual("dec Residual", inv=3 * cfg.n_layers)
        if include_bwd:
            self._attention_bwd("dec self ", inv=cfg.n_layers)
            self._attention_bwd("dec cross ", S_kv=F, causal=False,
                                inv=cfg.n_layers)
            self._mlp_bwd("dec ", inv=cfg.n_layers)

    def _ssm_layers(self, include_bwd: bool):
        cfg = self.cfg
        self._norm("Layernorm", inv=cfg.n_layers)
        self._ssm_fwd("", inv=cfg.n_layers)
        self._residual("Residual", inv=cfg.n_layers)
        if include_bwd:
            self._ssm_bwd("", inv=cfg.n_layers)

    def _hybrid_layers(self, include_bwd: bool):
        cfg = self.cfg
        n_attn = cfg.n_layers // cfg.attn_every \
            + (1 if cfg.n_layers % cfg.attn_every else 0)
        self._norm("Layernorm", inv=cfg.n_layers)
        self._ssm_fwd("", inv=cfg.n_layers)
        self._residual("Residual", inv=cfg.n_layers)
        d2 = 2 * cfg.d_model
        self._norm("shared Layernorm", inv=2 * n_attn, d=d2)
        self._attention_fwd("shared ", inv=n_attn, d_in=d2)
        self._mlp_fwd("shared ", inv=n_attn, d_in=d2)
        if include_bwd:
            self._ssm_bwd("", inv=cfg.n_layers)
            self._attention_bwd("shared ", inv=n_attn, d_in=d2)
            self._mlp_bwd("shared ", inv=n_attn, d_in=d2)

    # -- decode ---------------------------------------------------------------
    def _decode_kernels(self):
        """One decode step: GEMV projections + cache-read attention."""
        cfg = self.cfg
        B, S, db = self.B, self.S, self.db
        d = cfg.d_model

        def gemv(name, N, K, inv=1):
            # M = B: weight-read dominated
            self._gemm(name, B, N, K, inv=inv)

        if cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            if cfg.family == "hybrid":
                n_attn = cfg.n_layers // cfg.attn_every \
                    + (1 if cfg.n_layers % cfg.attn_every else 0)
                att_inv, d_in = n_attn, 2 * d
            elif cfg.family == "encdec":
                att_inv, d_in = cfg.n_layers, d
            else:
                att_inv, d_in = cfg.n_layers, d
            H = max(cfg.n_heads // self.tp, 1)
            KVh = max(cfg.n_kv_heads // self.tp, 1)
            hd = cfg.resolved_head_dim or (d_in // max(cfg.n_heads, 1))
            if cfg.attn_window and cfg.global_attn_every:
                g = cfg.global_attn_every
                plans = [("local ", att_inv * (g - 1) // g,
                          min(cfg.attn_window, S)),
                         ("global ", att_inv // g, S)]
            else:
                plans = [("", att_inv, S)]
            for prefix, inv, S_eff in plans:
                gemv(f"{prefix}GEMV qkv", (H + 2 * KVh) * hd, d_in, inv=inv)
                # cache-read attention: streams the whole KV cache at its
                # *stored* width (kv_db < db under a quantized page pool —
                # the kernel's arithmetic intensity rises accordingly;
                # per-page scale reads are < 0.5% of payload and elided)
                self._emit(f"{prefix}Attn cache read", "attn_decode",
                           4.0 * B * H * S_eff * hd,
                           self.kv_db * 2 * B * S_eff * KVh * hd, inv=inv)
                gemv(f"{prefix}GEMV attn proj", d, H * hd, inv=inv)
            if cfg.family == "encdec":
                F = cfg.encoder_frontend_len
                gemv("GEMV cross q", H * hd, d, inv=cfg.n_layers)
                self._emit("Cross cache read", "attn_decode",
                           4.0 * B * H * F * hd,
                           db * 2 * B * F * KVh * hd, inv=cfg.n_layers)
                gemv("GEMV cross proj", d, H * hd, inv=cfg.n_layers)
        if cfg.family in ("ssm", "hybrid"):
            s = cfg.ssm
            d_in = s.expand * d // self.tp
            nh = max(d_in // s.head_dim, 1)
            N, P = s.state_dim, s.head_dim
            proj_out = 2 * d_in + 2 * s.n_groups * N + nh
            gemv("GEMV in_proj", proj_out, d, inv=cfg.n_layers)
            self._emit("SSM state update", "scan", 4.0 * B * nh * N * P,
                       2 * 4 * B * nh * N * P, inv=cfg.n_layers)
            gemv("GEMV out_proj", d, d_in, inv=cfg.n_layers)
        if cfg.family in ("dense", "vlm") or cfg.is_moe:
            ff = max(cfg.d_ff // self.tp, 1)
            n_up = 2 if cfg.activation == "swiglu" else 1
            if cfg.is_moe:
                K = cfg.moe.top_k
                gemv("GEMV router", cfg.moe.n_experts, d, inv=cfg.n_layers)
                gemv("GEMV experts", K * (n_up + 1) * ff, d,
                     inv=cfg.n_layers)
                if cfg.moe.shared_expert:
                    gemv("GEMV shared", (n_up + 1) * ff, d, inv=cfg.n_layers)
            else:
                gemv("GEMV mlp", (n_up + 1) * ff, d, inv=cfg.n_layers)
        elif cfg.family in ("encdec", "hybrid") and cfg.d_ff:
            ff = max(cfg.d_ff // self.tp, 1)
            n_up = 2 if cfg.activation == "swiglu" else 1
            inv = cfg.n_layers if cfg.family == "encdec" else \
                cfg.n_layers // cfg.attn_every + 1
            gemv("GEMV mlp", (n_up + 1) * ff, 2 * d
                 if cfg.family == "hybrid" else d, inv=inv)
        # norms + unembed
        self._elem("Norms decode", "layernorm", B * d * 2 * cfg.n_layers,
                   rw=2, flops_per=6.0)
        gemv("GEMV lm_head", max(cfg.vocab_size // self.tp, 1), d)

    # -- entry point ------------------------------------------------------
    def build(self) -> List[KernelSpec]:
        self.kernels = []
        cfg, shape = self.cfg, self.shape
        if shape.kind == "decode":
            self._decode_kernels()
            return self.kernels
        include_bwd = shape.kind == "train"
        self._embedding(include_bwd)
        if cfg.family in ("dense", "moe", "vlm"):
            self._dense_layer(include_bwd)
        elif cfg.family == "encdec":
            self._encdec_layers(include_bwd)
        elif cfg.family == "ssm":
            self._ssm_layers(include_bwd)
        elif cfg.family == "hybrid":
            self._hybrid_layers(include_bwd)
        self._loss(include_bwd)
        if include_bwd and self.include_optimizer:
            self._optimizer()
        return self.kernels


def build_workload(cfg: ModelConfig, shape: ShapeConfig,
                   **kw) -> List[KernelSpec]:
    return WorkloadBuilder(cfg, shape, **kw).build()


def decode_slot_buckets(n_slots: int) -> List[int]:
    """Active-slot-count buckets for continuous-batching decode plans.

    Powers of two up to (and always including) ``n_slots``: a decode step
    with ``a`` active slots replays the plan of the smallest bucket
    >= ``a``, so a pool of S slots needs only O(log S) plans instead of S.
    """
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    buckets = [1]
    while buckets[-1] < n_slots:
        buckets.append(min(2 * buckets[-1], n_slots))
    return buckets


def pick_decode_bucket(buckets: List[int], n_active: int) -> int:
    """THE bucket-routing rule: smallest bucket >= n_active (largest if
    none).  Single-sourced so the plan IR and the legacy bundle shim can
    never route decode steps differently."""
    if not buckets:
        raise KeyError("no decode buckets to route to")
    for b in buckets:
        if b >= n_active:
            return b
    return buckets[-1]


def decode_bucket_workloads(cfg: ModelConfig, shape: ShapeConfig,
                            n_slots: int, **kw
                            ) -> "Dict[int, List[KernelSpec]]":
    """One decode-step kernel list per active-slot bucket.

    ``shape`` must be a decode shape; its ``global_batch`` is overridden
    with each bucket size (the decode workload scales with the number of
    sequences actually resident in the batch).
    """
    if shape.kind != "decode":
        raise ValueError(f"decode shape required, got kind={shape.kind!r}")
    return {b: WorkloadBuilder(cfg, shape, batch_override=b, **kw).build()
            for b in decode_slot_buckets(n_slots)}


def workload_totals(kernels: List[KernelSpec]):
    """Aggregate (flops, hbm_bytes, ici_bytes) over invocations."""
    f = sum(k.flops * k.invocations for k in kernels)
    h = sum(k.hbm_bytes * k.invocations for k in kernels)
    i = sum(k.ici_bytes * k.invocations for k in kernels)
    return f, h, i
