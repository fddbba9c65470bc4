"""The yardstick's arithmetic: the card's published peaks, the operations a
model step needs, and the least time of each attention kernel call.

Operations count what the algorithm needs, never what a program recomputes:
no remat rerun, no logits computed past the position that is read, no
matmul for an embedding lookup. Plain Python on the configuration's numbers,
so it runs anywhere and the tests check it by hand.
"""

from __future__ import annotations

from typing import Dict

# Published dense peaks of the cards this benchmark knows (NVIDIA's data
# sheet for the H100 SXM part, at its 700 W limit), by the name that
# torch.cuda.get_device_name() gives. A card that is not here fails the run:
# no peak is guessed.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12, "bytes": 3.35e12},
}


def peak(device_name: str) -> Dict[str, float]:
    if device_name not in PEAKS:
        raise RuntimeError(f"no published peak for the card {device_name!r}; add it to "
                           "benchmark/counts.py PEAKS from its data sheet")
    return PEAKS[device_name]


def layer_matmul_params(m: dict) -> int:
    """Weights of one decoder layer that take part in a matmul: q, k, v and
    o projections and the three SwiGLU matrices."""
    d, hd = m["hidden_size"], m["head_dim"]
    attn = d * hd * (2 * m["num_attention_heads"] + 2 * m["num_key_value_heads"])
    return attn + 3 * d * m["intermediate_size"]


def head_params(m: dict) -> int:
    return m["hidden_size"] * m["vocab_size"]


def matmul_params(m: dict) -> int:
    """N_nonemb: every weight that a token's forward multiplies, the output
    head included and the embedding table (a lookup) left out."""
    return m["num_hidden_layers"] * layer_matmul_params(m) + head_params(m)


def visible_pairs(sq: int, sk: int, causal: bool = True) -> int:
    """(query, key) pairs a causal mask leaves, query i seeing keys 0..i."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


def attention_forward_flops(m: dict, seq: int) -> int:
    """QK^T and PV over the visible pairs of one sequence, every layer."""
    heads = m["num_attention_heads"]
    return m["num_hidden_layers"] * 4 * heads * m["head_dim"] * visible_pairs(seq, seq)


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward of one token of a [*, seq] batch: 6 N_nonemb,
    and three times the causal attention products (6 L d S / 2 per token on
    average, exactly as the visible pairs give it)."""
    return 6 * matmul_params(m) + 3 * attention_forward_flops(m, seq) / seq


def _least_s(flops: float, nbytes: float, pk: Dict[str, float]) -> float:
    return max(flops / pk["bf16_flops"], nbytes / pk["bytes"])


def flash_fwd_bound_s(b: int, s: int, h: int, hkv: int, d: int, pk: Dict[str, float]) -> float:
    """Least time of one bf16 causal forward call (B1) on [b, s, h, d] with
    hkv kv heads: q, k, v and o moved once, the lse written once, the two
    products over the visible pairs (chip_smoke.attention_bound)."""
    flops = 4 * d * visible_pairs(s, s) * b * h
    nbytes = (2 * b * s * h * d + 2 * b * s * hkv * d) * 2 + b * h * s * 4
    return _least_s(flops, nbytes, pk)


def flash_bwd_bound_s(b: int, s: int, h: int, hkv: int, d: int, pk: Dict[str, float]) -> float:
    """Least time of one causal backward (B2 + B3 + the delta pre-pass),
    counting what the algorithm needs however the kernels split it: the five
    products over the visible pairs (S and dP recomputed once, dV, dK, dQ),
    q, k, v, dO, lse and delta read once, dq, dk and dv written once; and
    delta's pass, which reads dO and o and writes [b, h, s] in f32.
    (chip_smoke.backward_bounds counts seven products: the split kernels'
    second S and dP.)"""
    product = 2 * d * visible_pairs(s, s) * b * h
    q_bytes, kv_bytes = b * s * h * d * 2, b * s * hkv * d * 2
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * b * h * s * 4
    grads = _least_s(5 * product, reads + q_bytes + 2 * kv_bytes, pk)
    delta = _least_s(2 * b * s * h * d, 2 * q_bytes + b * h * s * 4, pk)
    return grads + delta
