#!/usr/bin/env python3
"""Where the time of the new full-width serving paths of ``chip_smoke.py``
goes on the card (bf16, random weights from a seed):

  * qwen3-moe-30b-a3b, all 48 layers: the batch-1 prefill of a 2048-token
    prompt at its exact length (as ``SlotEngine.insert`` runs it), then
    one decode round of 8 slots, each holding such a request (one MoE
    group of 8 tokens, capacity 1: every expert's weights are read);
  * qwen3-8b at ``get_config(shape="long_500k")`` (window 4096), all 36
    layers: one decode step on the ring caches after a 32,768-token
    prompt.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 scripts/torch_zoo_decode_profile.py

For each, ``torch_prefill_profile.profile`` prints the host-clock median
of its calls (each ends in a device sync: the tokens read back), then
traces one with ``torch.profiler``: the card's busy time (the sum of
kernel times), its idle share of the wall time, the kernels launched,
and those that take the most device time.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import configs, models, serve  # noqa: E402
from torch_prefill_profile import profile  # noqa: E402

PROMPT, SLOTS = 2048, 8
CACHE_LEN = PROMPT + 512 + cs.SERVE_NEW        # the serve run's slots


def tokens(vocab: int, n: int, seed: int) -> torch.Tensor:
    return torch.randint(0, vocab, (1, n), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))


def moe() -> None:
    cfg = configs.get_config(cs.MOE_ARCH)
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = tokens(cfg.vocab_size, PROMPT, 1)

    def prefill():
        logits, _ = models.prefill(params, cfg, {"tokens": toks},
                                   extra_capacity=CACHE_LEN - PROMPT,
                                   last_pos=PROMPT - 1)
        return int(logits.argmax())          # the first token's sync

    profile(prefill, f"prefill {cfg.name} S={PROMPT} exact length")
    engine = serve.SlotEngine(params, cfg, slots=SLOTS, cache_len=CACHE_LEN)
    for i in range(SLOTS):
        engine.insert(serve.Request(
            rid=i, prompt=tokens(cfg.vocab_size, PROMPT, 2 + i)[0].tolist(),
            max_new_tokens=CACHE_LEN - PROMPT))
    profile(engine.decode_round,
            f"{cfg.name} decode round of {SLOTS} slots")


def long_context() -> None:
    cfg = configs.get_config(cs.LONG_ARCH, shape="long_500k")
    params = models.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    logits, state = models.prefill(
        params, cfg, {"tokens": tokens(cfg.vocab_size, cs.LONG_PREFIX, 1)})
    box = {"state": state, "tok": logits.argmax(-1)}

    def step():
        logits, box["state"] = models.decode_step(params, cfg, box["state"],
                                                  box["tok"])
        box["tok"] = logits.argmax(-1)
        return int(box["tok"][0])

    profile(step, f"{cfg.name} long_500k ring decode step after "
                  f"{cs.LONG_PREFIX} tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_zoo_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    with torch.no_grad():
        moe()
        torch.cuda.empty_cache()
        long_context()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
