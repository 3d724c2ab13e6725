"""Batched greedy generation with the cached serve step, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch recurrentgemma-2b] [--full-config] \\
        [--batch 4] [--prompt-len 16] [--gen 32] [--device cuda|cpu] [--seed 0]

The same loop and defaults as the reference's ``src/repro/launch/serve.py``:
the prompt is fed one token at a time through the decode step (prefill is
decode), then the greedy tokens.  Architectures: those of
``repro_torch.configs`` (``--arch``; the default recurrentgemma-2b is the
RG-LRU hybrid, xlstm-1.3b the mLSTM/sLSTM stack, mixtral-8x22b and
dbrx-132b mixture-of-experts models, the others dense attention-only),
reduced unless ``--full-config`` (a full-depth MoE model, 281 or 263 GB in
bf16, does not fit one card).  Parameters are the reference's
``init(PRNGKey(seed))`` for ``--seed``, drawn on the device.  Runs on CUDA
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.steps import build_serve_step
from repro_torch.models.transformer import TransformerLM


def generate(model: TransformerLM, params, prompt: torch.Tensor, gen: int, cache_len: int,
             *, on_step: Optional[Callable[[int], None]] = None) -> torch.Tensor:
    """prompt (B, P) int64 on the parameters' device → (B, P + gen).

    Runs P + gen − 1 decode steps; nothing in the loop waits on the device.
    ``on_step(position)``, if given, is called after each step has been queued
    (a caller that times steps synchronises there)."""
    b, plen = prompt.shape
    cache = model.init_cache(b, cache_len, device=prompt.device)
    serve = build_serve_step(model)
    tok = prompt[:, :1]
    out = [tok]
    for pos in range(plen + gen - 1):
        nxt, _, cache = serve(params, tok, cache, pos)
        tok = prompt[:, pos + 1:pos + 2] if pos + 1 < plen else nxt[:, None]
        out.append(tok)
        if on_step is not None:
            on_step(pos)
    return torch.cat(out, dim=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs(), default="recurrentgemma-2b")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=not args.full_config)
    model = TransformerLM(cfg)
    params = model.init(args.seed, dev)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int64)).to(dev)
    t0 = time.perf_counter()
    seq = generate(model, params, prompt, args.gen, args.prompt_len + args.gen)
    first = seq[0, :24].tolist()                       # waits for the device
    dt = time.perf_counter() - t0
    total_new = args.batch * args.gen
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {cfg.name} on {where}: generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s, batch={args.batch}, "
          f"{args.prompt_len + args.gen - 1} decode steps)")
    print(f"[serve] first sequence: {first} ...")


if __name__ == "__main__":
    main()
