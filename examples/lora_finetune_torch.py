"""Federated LoRA fine-tuning of a transformer on the PyTorch port.

    PYTHONPATH=src python examples/lora_finetune_torch.py [--device cuda|cpu] [--full-config]

Each of 16 clients holds next-token data from its own topic mixture
(``make_federated_lm``); the clients train rank-8 LoRA adapters of a frozen
gemma3 ``LMClassifier`` (``LoRAClassifier``), and only the adapters are
aggregated, sent and charged to the ledger.  FLrce selects 4 clients a
round by their relationships and stops early on conflicts, over the flat
adapter vector.  The architecture is reduced unless ``--full-config``
(gemma3-4b at full width is 3.88 B bf16 parameters; rank-8 adapters make
D = 14,901,248).  Weights are random, drawn from seed 0.  Runs on CUDA
unless ``--device cpu`` is given.
"""
import argparse

from repro_torch.configs import get_arch
from repro_torch.data import make_federated_lm
from repro_torch.device import resolve_device
from repro_torch.fl import FLrce, run_federated
from repro_torch.models import LMClassifier, LoRAClassifier, param_count

CLIENTS, PARTICIPANTS, SAMPLES, SEQ = 16, 4, 16, 64
RANK, ROUNDS, LR, BATCH, SEED = 8, 3, 0.01, 8, 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full-config", action="store_true")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = get_arch("gemma3-4b", reduced=not args.full_config)
    base = LMClassifier(cfg, seq_len=SEQ)
    base_params = base.init(SEED, dev)
    model = LoRAClassifier(base, base_params, rank=RANK)
    dim = model.adapter_dim()
    print(f"{cfg.name}: {param_count(base_params):,} frozen {cfg.dtype} parameters, "
          f"rank-{RANK} adapters D = {dim:,}")
    ds = make_federated_lm(num_clients=CLIENTS, samples_per_client=SAMPLES, seq_len=SEQ,
                           vocab_size=cfg.vocab_size, num_eval=64, seed=SEED)
    strategy = FLrce(CLIENTS, PARTICIPANTS, 1, dim=dim, explore_decay=0.5, seed=SEED)
    result = run_federated(model, ds, strategy, max_rounds=ROUNDS, learning_rate=LR,
                           batch_size=BATCH, seed=SEED, verbose=True, torch_device=dev)
    print(f"\n=== LoRA fine-tuning summary ({dev.type}) ===")
    for k, v in result.summary().items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
