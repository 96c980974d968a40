"""Architecture config and the shared building blocks of the LMs.

Counterpart of ``repro.models.common``, with the fields the dense, MoE,
RWKV6 (``"ssm"``), Mamba2 hybrid (``"hybrid"``), whisper encoder-decoder
(``"audio"``) and embeddings-in (``"vlm"``) families use.
Layouts follow the JAX package: linears are ``(in, out)`` for ``x @ W``,
rotary embedding rotates split halves (not interleaved pairs).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (full or reduced/smoke variant)."""

    name: str
    family: str                     # dense | moe | ssm (RWKV6) | hybrid
                                    # (Mamba2 + shared attention) | audio
                                    # (encoder-decoder) | vlm
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
    vocab_pad_to: int = 0           # embed/unembed rows (0 = off); logits
                                    # are sliced back to vocab_size
    head_pad_to: int = 0            # pad the RWKV6 decode state's heads to
                                    # this count (0 = off); exact: padded
                                    # channels stay zero
    attn_every: int = 0             # hybrid: the shared attention block
                                    # after every k-th layer (0 = none)
    # encoder-decoder (audio): the encoder takes precomputed frame
    # embeddings (the mel front end is stubbed, as in JAX)
    encoder_layers: int = 0
    encoder_seq: int = 0            # frames (whisper: 1500)
    input_mode: str = "tokens"      # tokens | embeds (vlm: the vision
                                    # front end is stubbed)
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
    def padded_vocab(self) -> int:
        """Rows of the embed and unembed parameters (``vocab_pad_to`` when
        it is larger); padded ids are never produced."""
        return max(self.vocab_pad_to, self.vocab_size)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), JAX's
        formula: it leaves out the padded vocabulary rows and whisper's
        cross-attention."""
        d, hd = self.d_model, self.hd
        attn = d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
        if self.family == "ssm":      # rwkv6: attention-free
            attn = 0
        if self.is_moe:
            mlp = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        else:
            mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d
        if self.family == "ssm":
            per_layer = 4 * d * d + 2 * d * 64 + 3 * d * self.d_ff + 2 * d
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state) + d_in * d + 2 * d
        emb = self.vocab_size * d * 2   # embed + unembed (untied)
        total = self.num_layers * per_layer + emb
        if self.is_encdec:
            total += self.encoder_layers * (attn + mlp + 2 * d)
        if self.family == "hybrid" and self.attn_every:
            total += attn + 3 * d * self.d_ff   # one shared block
        return int(total)


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


SLICED_DRAW = 1 << 30


class MetaGenerator:
    """The generator :func:`repro_torch.models.init_params` takes to build
    a parameter tree on the ``meta`` device: every leaf has its shape and
    dtype, nothing is allocated and nothing is drawn (no
    ``torch.Generator`` lives on ``meta``).  A CPU or CUDA generator draws
    as before."""

    device = torch.device("meta")


def init_linear(shape, dtype: torch.dtype, generator: torch.Generator,
                scale=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in),
    fan_in = ``shape[-2]``), drawn in fp32 on the generator's device.  A
    stack (three or more dims) of more than ``SLICED_DRAW`` elements is
    drawn one leading slice at a time, so the fp32 draw holds one layer,
    not the stack (a 32-layer internvl2 MLP leaf would take 30 GB)."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else float(fan_in) ** -0.5
    if len(shape) >= 3 and math.prod(shape) > SLICED_DRAW:
        out = torch.empty(shape, dtype=dtype, device=generator.device)
        for i in range(shape[0]):
            out[i] = init_linear(shape[1:], dtype, generator, scale)
        return out
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(scale).to(dtype)
