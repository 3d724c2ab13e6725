"""Federated next-token datasets from the silo token streams, a copy of the
reference's ``src/repro/data/lm.py``.

Packs :class:`repro_torch.data.tokens.SiloTokenStream` draws into the
engines' :class:`~repro_torch.data.synthetic.FederatedDataset` layout, so a
transformer (through :class:`repro_torch.models.lm.LMClassifier`) trains
through every engine and driver unchanged:

* ``x[i]``   — ``(seq_len,)`` float32 token ids (the input sequence)
* ``y[i]``   — int32 next token after the sequence (the final-position
               label; the LM loss also supervises every interior next-token
               position from ``x`` itself)
* classes    — the vocabulary.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import FederatedDataset
from repro_torch.data.tokens import SiloTokenStream


def make_federated_lm(
    *,
    num_clients: int = 8,
    samples_per_client: int = 32,
    seq_len: int = 16,
    vocab_size: int = 256,
    num_eval: int = 64,
    num_topics: int = 8,
    alpha: float = 0.3,
    seed: int = 0,
) -> FederatedDataset:
    """Topic-skewed per-silo token data in the federated-classification shape.

    Silo ``k < num_clients`` feeds client ``k``; one extra silo (an unseen
    topic mixture) provides the eval split.  Token ids ride in float32
    features, exact below 2**24, because the client stores stack float32
    features.
    """
    stream = SiloTokenStream(
        vocab_size, num_clients + 1, num_topics=num_topics, alpha=alpha, seed=seed,
    )
    xs, ys, client_indices = [], [], []
    offset = 0
    for k in range(num_clients):
        seqs = stream.batch(k, samples_per_client, seq_len, step=0)
        xs.append(seqs[:, :-1].astype(np.float32))
        ys.append(seqs[:, -1].astype(np.int32))
        client_indices.append(np.arange(offset, offset + samples_per_client))
        offset += samples_per_client
    eval_seqs = stream.batch(num_clients, num_eval, seq_len, step=1)
    return FederatedDataset(
        x=np.concatenate(xs),
        y=np.concatenate(ys),
        client_indices=client_indices,
        eval_x=eval_seqs[:, :-1].astype(np.float32),
        eval_y=eval_seqs[:, -1].astype(np.int32),
        num_classes=vocab_size,
    )
