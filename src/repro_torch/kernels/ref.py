"""Plain PyTorch versions of the kernels (the correctness contract).

Counterpart of ``repro.kernels.ref``: each CUDA kernel in this package has
a function here that computes the same thing.  The CPU path and the tests
run these; ``chip_smoke.py`` holds each kernel against them on the card.
The Mamba2 chunked scan has no kernel (nor a Pallas one in the JAX
package); its sequential oracle sits here all the same, as in JAX.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def dual_update_ref(z: torch.Tensor, w0: torch.Tensor,
                    beta: float) -> torch.Tensor:
    """Fused dual-averaging prox: w = w0 - z / (2 beta), fp32 math."""
    return w0.float() - z.float() / (2.0 * torch.tensor(
        beta, dtype=torch.float32, device=z.device))


def gossip_combine_ref(m: torch.Tensor, src: torch.Tensor,
                       weights) -> torch.Tensor:
    """One tap-gossip round: ``out[i] = sum_k weights[k] * m[src[k, i]]``.

    m: (n, D) source rows; src: (K, n_out) rows of m per tap; weights: K
    floats; returns (n_out, D).  The gathered rows of one tap at a time
    (``_roll_taps`` + the weighted sum of ``repro.kernels.ref.
    gossip_combine_ref``), summed in fp32 in tap order from 0; one
    (n_out, D) gather is live at a time.  A process per worker passes the
    K rows it received and a (K, 1) table, and gets the stacked round's
    own row bit for bit.
    """
    m = m.float()
    idx = src.long()
    out = torch.zeros((src.shape[1], m.shape[1]), dtype=torch.float32,
                      device=m.device)
    for k, w in enumerate(weights):
        out.add_(m[idx[k]].mul_(float(w)))
    return out


def stochastic_quantize_ref(m: torch.Tensor, h: torch.Tensor,
                            rnd: torch.Tensor, lo: torch.Tensor,
                            scale: torch.Tensor, levels: float = 255.0):
    """Send half of a quantized gossip round.

    m, h, rnd: (n, D); lo, scale: (n, 1) row grids.  Returns (levels (n, D)
    uint8, h_new (n, D) fp32): ``u = (m - h - lo) / scale`` rounded down,
    plus one where ``rnd < frac(u)``, capped at ``levels``; and the public
    replica ``(h + lo) + levels * scale``.  Each product and sum is its own
    op, in the order of ``repro.kernels.ref.stochastic_quantize_ref``.
    """
    h = h.float()
    lo, scale = lo.float().reshape(-1, 1), scale.float().reshape(-1, 1)
    u = ((m.float() - h) - lo) / scale
    fl = torch.floor(u)
    lvl = torch.clamp(fl + (rnd < (u - fl)).float(), max=float(levels))
    return lvl.to(torch.uint8), (h + lo) + lvl * scale


def quantized_combine_ref(m: torch.Tensor, hnbr: torch.Tensor,
                          lvl: torch.Tensor, lo: torch.Tensor,
                          scale: torch.Tensor, src: torch.Tensor, weights):
    """Receive half: dequantize the neighbours' deltas, update the
    neighbour replicas, combine.

    m: (n, D); hnbr: (K-1, n, D) replicas; lvl: (n, D) uint8, the level
    plane every worker sent this round; lo, scale: (n, 1); src: (K, n)
    source rows per tap, self tap first.  Tap k >= 1 of row i reads row
    ``s = src[k, i]``: ``hnbr_new[k-1, i] = (hnbr[k-1, i] + lo[s]) +
    lvl[s] * scale[s]``, and ``out = w0 m + sum_k w_k hnbr_new[k-1]``,
    summed in tap order.  Returns (out (n, D), hnbr_new (K-1, n, D)); the
    gathers are what ``taps.take`` does in ``repro.dist.consensus``.
    """
    idx = src.long()
    w = [float(x) for x in weights]
    lo, scale = lo.float().reshape(-1, 1), scale.float().reshape(-1, 1)
    hnbr_new = torch.empty(hnbr.shape, dtype=torch.float32,
                           device=hnbr.device)
    out = w[0] * m.float()
    for k in range(1, len(w)):
        s = idx[k]
        hnbr_new[k - 1] = (hnbr[k - 1].float() + lo[s]) \
            + lvl[s].float() * scale[s]
        out = out + w[k] * hnbr_new[k - 1]
    return out, hnbr_new


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention, the oracle of the flash kernel.

    q: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); query head h reads KV head
    h // G (H = KV G).  Scores are divided by the fp32 sqrt(hd) and set to
    -1e30 where the mask says no (``k_pos <= q_pos`` when causal,
    ``q_pos - k_pos < window`` when window > 0, ``q_pos = q_offset +
    row``); a row with no valid key therefore averages v over all keys.
    Returns (B, H, Sq, hd) fp32, as ``repro.kernels.ref.flash_attention_ref``.
    """
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, kvh, g, sq, hd)
    root = torch.sqrt(torch.tensor(float(hd), device=q.device))
    s = torch.einsum("bkgqh,bkch->bkgqc", qf, k.float()) / root
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bkch->bkgqh", p, v.float())
    return out.reshape(b, h, sq, hd)


def rwkv6_chunk_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    decay: torch.Tensor, u: torch.Tensor) -> tuple:
    """RWKV6 wkv over the whole sequence from a zero state, the sequential
    oracle of the scan kernel (no chunks, so no exponent clip).

    r, k, v, decay: (B, H, S, hd), decay in (0, 1]; u: (H, hd) current-token
    bonus.  Per token: ``y_t = r_t (S + u k_t^T v_t)``, then ``S <- d_t S +
    k_t^T v_t``, in fp32, as ``repro.kernels.ref.rwkv6_chunk_ref``.
    Returns (y (B, H, S, hd), the state after the last token (B, H, hd,
    hd)), fp32.
    """
    b, h, s, hd = r.shape
    rf, kf, vf, df = (t.float() for t in (r, k, v, decay))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    y = torch.empty((b, h, s, hd), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = torch.einsum("bhd,bhe->bhde", kf[:, :, t], vf[:, :, t])
        y[:, :, t] = torch.einsum("bhd,bhde->bhe", rf[:, :, t],
                                  state + uf * kv)
        state = df[:, :, t, :, None] * state + kv
    return y, state


def mamba2_chunk_ref(x: torch.Tensor, b_mat: torch.Tensor,
                     c_mat: torch.Tensor, decay: torch.Tensor) -> tuple:
    """Mamba2 (SSD) over the whole sequence from a zero state, the
    sequential oracle of the chunked scan (no chunks, no exponent).

    x: (B, S, H, hd) dt-scaled inputs; b_mat, c_mat: (B, S, ns); decay:
    (B, S, H) in (0, 1].  Per token: ``h <- d_t h + x_t^T B_t``, then
    ``y_t = h C_t``, in fp32, as ``repro.kernels.ref.mamba2_chunk_ref``.
    Returns (y (B, S, H, hd), the state after the last token (B, H, hd,
    ns)), fp32.
    """
    bsz, s, h, hd = x.shape
    xf, bf, cf, df = (t.float() for t in (x, b_mat, c_mat, decay))
    state = torch.zeros((bsz, h, hd, b_mat.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        state = df[:, t, :, None, None] * state + torch.einsum(
            "bhd,bs->bhds", xf[:, t], bf[:, t])
        ys.append(torch.einsum("bhds,bs->bhd", state, cf[:, t]))
    return torch.stack(ys, dim=1), state
