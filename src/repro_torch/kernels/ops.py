"""Public kernel wrappers: the CUDA kernel on the card, plain torch on CPU.

Counterpart of ``repro.kernels.ops``.  Each wrapper asks
:mod:`repro_torch.kernels.router` which body runs for its input tensor;
``force`` overrides that for one call (tests, ``chip_smoke.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref, router
from .dual_update import dual_update_cuda
from .flash_attention import flash_attention_cuda
from .gossip_combine import check_out, gossip_combine_cuda
from .quantized_combine import check_combine_out, quantized_combine_cuda
from .rwkv6_scan import rwkv6_scan_cuda
from .stochastic_quantize import check_quantize_out, stochastic_quantize_cuda


def dual_update(z: torch.Tensor, w0: torch.Tensor, beta: float,
                radius: Optional[float] = None,
                force: Optional[str] = None) -> torch.Tensor:
    """w = w0 - z/(2 beta) in fp32, optionally projected onto
    ``||w - w0|| <= radius`` (the norm is taken over this one tensor)."""
    if router.resolve(z, force) == "kernel":
        w = dual_update_cuda(z, w0, beta)
    else:
        w = ref.dual_update_ref(z, w0, beta)
    if radius is not None:
        w0f = w0.float()
        delta = w - w0f
        nrm = torch.linalg.vector_norm(delta.reshape(-1))
        w = w0f + delta * torch.clamp(radius / torch.clamp(nrm, min=1e-30),
                                      max=1.0)
    return w


def gossip_combine(m: torch.Tensor, src: torch.Tensor, weights,
                   out: Optional[torch.Tensor] = None,
                   force: Optional[str] = None) -> torch.Tensor:
    """One gossip round: ``out[i] = sum_k weights[k] * m[src[k, i]]``, fp32.
    ``m`` is the (n, D) stack of source rows and ``src`` the (K, n_out)
    tap table (n_out = n for the stacked round; a process per worker
    passes its K received rows and a (K, 1) table).  ``out``, if given,
    receives the result: an (n_out, D) fp32 buffer apart from ``m``."""
    if router.resolve(m, force) == "kernel":
        return gossip_combine_cuda(m, src, weights, out)
    res = ref.gossip_combine_ref(m, src, weights)
    if out is None:
        return res
    check_out(m, src, out)
    return out.copy_(res)


def stochastic_quantize(m: torch.Tensor, h: torch.Tensor, rnd: torch.Tensor,
                        lo: torch.Tensor, scale: torch.Tensor,
                        levels: float = 255.0, out: Optional[tuple] = None,
                        force: Optional[str] = None) -> tuple:
    """Send half of a quantized gossip round on the (n, D) stack: the
    uint8 levels of ``m - h`` on the row grids (lo, scale: (n, 1)) rounded
    by the draws ``rnd``, and the new public replica.  ``out = (lvl,
    h_new)``, if given, receives them; ``h_new`` may be ``h``."""
    if router.resolve(m, force) == "kernel":
        return stochastic_quantize_cuda(m, h, rnd, lo, scale, levels, out)
    res = ref.stochastic_quantize_ref(m, h, rnd, lo, scale, levels)
    if out is None:
        return res
    lvl, h_new = check_quantize_out(m, h, rnd, out)
    return lvl.copy_(res[0]), h_new.copy_(res[1])


def quantized_combine(m: torch.Tensor, hnbr: torch.Tensor, lvl: torch.Tensor,
                      lo: torch.Tensor, scale: torch.Tensor,
                      src: torch.Tensor, weights,
                      out: Optional[tuple] = None,
                      force: Optional[str] = None) -> tuple:
    """Receive half: the (K-1, n, D) neighbour replicas take the levels
    ``lvl`` (n, D) of the rows the (K, n) tap table ``src`` names, and
    ``out = w0 m + sum_k w_k hnbr_new[k-1]``.  ``out = (out, hnbr_new)``,
    if given, receives them; ``out`` may be ``m``, ``hnbr_new`` ``hnbr``."""
    if router.resolve(m, force) == "kernel":
        return quantized_combine_cuda(m, hnbr, lvl, lo, scale, src, weights,
                                      out)
    res = ref.quantized_combine_ref(m, hnbr, lvl, lo, scale, src, weights)
    if out is None:
        return res
    dest, hnbr_new = check_combine_out(m, hnbr, lvl, out)
    return dest.copy_(res[0]), hnbr_new.copy_(res[1])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    force: Optional[str] = None) -> torch.Tensor:
    """(B, H, Sq, hd) x (B, KV, Skv, hd) -> (B, H, Sq, hd) in q's dtype.

    Forward only: on the card it raises for inputs that require grad (there
    is no backward kernel yet, and it never falls back to the plain version).
    """
    if router.resolve(q, force) == "kernel":
        if q.requires_grad or k.requires_grad or v.requires_grad:
            raise RuntimeError("flash_attention has no backward kernel yet; "
                               "call it on tensors that do not require grad "
                               "(torch.no_grad())")
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset).to(q.dtype)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               decay: torch.Tensor, u: torch.Tensor,
               force: Optional[str] = None) -> tuple:
    """The RWKV6 wkv scan from a zero state.

    r, k, v, decay: (B, H, S, hd), u (H, hd) (JAX's flat (BH, S, hd) form
    is (1, BH, S, hd) here); any float dtype, computed in fp32.  Returns
    (y fp32 (B, H, S, hd), the fp32 (B, H, hd, hd) state after token S).
    Forward only: on the card it raises where autograd would need a
    gradient of an input (there is no backward kernel, and it never falls
    back to the plain version).
    """
    if router.resolve(r, force) == "kernel":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, decay, u)):
            raise RuntimeError("rwkv6_scan has no backward kernel; call it "
                               "under torch.no_grad() or on tensors that do "
                               "not require grad")
        return rwkv6_scan_cuda(r, k, v, decay, u)
    return ref.rwkv6_chunk_ref(r, k, v, decay, u)
