"""Batched-request serving with the cached decode path, on the PyTorch port.

    PYTHONPATH=src python examples/serve_decode_torch.py [--arch recurrentgemma-2b] [--device cuda|cpu]

``examples/serve_decode.py`` on ``repro_torch``: serves a REDUCED variant of
the chosen architecture.  A batch of prompts is prefilled token by token
and then decoded greedily, through every cache kind the port has: KV ring
buffers (local attention), full KV caches (global attention), the mLSTM's
matrix memory and the sLSTM's and RG-LRU's states, and through the
mixture-of-experts MLP's drop-free routing (mixtral-8x22b, dbrx-132b).
``--arch`` offers the port's architectures
(``repro_torch.configs.list_archs()``); the reference's whisper (its
cross-KV cache) and VLM architectures wait for ROADMAP A.7.5 and A.7.6.
The weights are the reference's ``init(PRNGKey(0))`` and the prompts its
NumPy draw, so both print the same tokens from the same config.  Runs on
CUDA unless ``--device cpu`` is given.
"""
import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import TransformerLM


def main(argv: Optional[List[str]] = None) -> torch.Tensor:
    """Serve the batch; return the (batch, prompt + gen) tokens."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs(), default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch, reduced=True)
    model = TransformerLM(cfg, remat=False)
    params = model.init(0, dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int64)).to(dev)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.gen, args.prompt_len + args.gen)
    out = out.cpu()                                     # waits for the device
    dt = time.perf_counter() - t0
    new_tokens = args.batch * args.gen
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the CPU"
    print(f"[serve] {cfg.name}: {args.batch} requests x {args.gen} new tokens "
          f"in {dt:.2f}s ({new_tokens / dt:.1f} tok/s on {where})")
    for i in range(min(2, args.batch)):
        seq = out[i].tolist()
        print(f"  request {i}: prompt={seq[:args.prompt_len]} -> "
              f"continuation={seq[args.prompt_len:args.prompt_len + 12]}...")
    return out


if __name__ == "__main__":
    main()
