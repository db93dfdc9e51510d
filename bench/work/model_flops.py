"""Model FLOPs of a served dense decoder, per token, at 2 FLOPs a
multiply-add (priced at the bfloat16 tensor-core rate).

A token of a prompt or a generated token passes every layer's
projections (2 x parameters of q, k, v, o, gate, up and down) and
attends its causal context (q.k and p.v: 4 x heads x head_dim x
positions).  The tied head (2 x vocab x d_model) is counted only for
the tokens whose logits are used: the last prompt token, which gives
the first token, and each fed-back generated token.
"""

from __future__ import annotations


def layer_params(c: dict) -> int:
    d, ff = c["d_model"], c["d_ff"]
    q, kv = c["n_heads"] * c["head_dim"], c["n_kv_heads"] * c["head_dim"]
    return d * q + 2 * d * kv + q * d + 3 * d * ff


def token_flops(c: dict, position: int, head: bool) -> float:
    """FLOPs of one token at 0-based `position` through all layers."""
    per_layer = 2 * layer_params(c) + 4 * c["n_heads"] * c["head_dim"] * (position + 1)
    return c["n_layers"] * per_layer + (2 * c["vocab_size"] * c["d_model"] if head else 0)


def request_flops(c: dict, prompt_len: int, generated: int) -> float:
    """A request's prompt and its `generated` tokens (the first comes
    from the prompt's last position, each later one from feeding the
    previous back)."""
    total = sum(token_flops(c, p, head=(p == prompt_len - 1)) for p in range(prompt_len))
    total += sum(token_flops(c, prompt_len + j, head=True) for j in range(generated - 1))
    return total
