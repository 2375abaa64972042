"""Model FLOPs of the plain dense LM (``reference/dense_lm.py``): every
product is ``2 * M * N * K``: per token and layer the q, k, v and o
projections and the three MLP products, per sequence and layer the
(S, S) score and value products of every head over the whole square
(the causal mask is not subtracted), and per token the tied read-out.
Every product's inputs need gradients, so the backward is twice the
forward. Norms, RoPE, softmax and the loss are not counted."""
from __future__ import annotations


def forward(cfg: dict, seq_len: int) -> int:
    """FLOPs of one sequence's forward pass."""
    d, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ff, V, L = cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    hd = cfg["head_dim"]
    per_token = L * (2 * d * H * hd + 2 * 2 * d * KV * hd + 2 * H * hd * d + 3 * 2 * d * ff)
    per_token += 2 * d * V
    return seq_len * per_token + L * 2 * 2 * H * seq_len * seq_len * hd


def train(cfg: dict, seq_len: int) -> int:
    return 3 * forward(cfg, seq_len)


def round_flops(traffic: dict, cfg: dict, val_rows: int) -> int:
    """A round's model FLOPs: every client's local steps over its batch
    of sequences, then the eval forward over the real val sequences."""
    S = traffic["data"]["seq_len"]
    r = traffic["round"]
    return (r["local_steps"] * r["n_clients"] * r["batch_size"] * train(cfg, S)
            + val_rows * forward(cfg, S))
