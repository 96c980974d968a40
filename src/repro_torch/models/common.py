"""Architecture config and the shared building blocks of the LMs.

Counterpart of ``repro.models.common``, with the fields the dense, MoE,
RWKV6 (``"ssm"``) and Mamba2 hybrid (``"hybrid"``) families use.
Layouts follow the JAX package: linears are ``(in, out)`` for ``x @ W``,
rotary embedding rotates split halves (not interleaved pairs).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (full or reduced/smoke variant)."""

    name: str
    family: str                     # dense | moe | ssm (RWKV6) | hybrid
                                    # (Mamba2 + shared attention): the
                                    # ported ones
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qk_norm: bool = False           # RMS-norm q and k per head (qwen3)
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    sliding_window: int = 0         # 0 = full attention; >0 = SWA width
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0              # Mamba2 state width (B and C columns)
    ssm_expand: int = 2             # Mamba2 inner width over d_model
    conv_width: int = 4             # Mamba2 depthwise causal conv taps
    ssm_chunk: int = 256            # chunk of the RWKV6 and Mamba2 scans
    head_pad_to: int = 0            # pad the RWKV6 decode state's heads to
                                    # this count (0 = off); exact: padded
                                    # channels stay zero
    attn_every: int = 0             # hybrid: the shared attention block
                                    # after every k-th layer (0 = none)
    dtype: str = "bfloat16"
    # bf16 expert products return fp32 (JAX's preferred_element_type on
    # the MXU); the smoke configs turn it off, as JAX's do
    mxu_f32_accum: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def init_linear(shape, dtype: torch.dtype, generator: torch.Generator,
                scale=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in),
    fan_in = ``shape[-2]``), drawn in fp32 on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else float(fan_in) ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale).to(dtype)
