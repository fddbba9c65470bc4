"""The yardstick's arithmetic: the card's published peaks, the least time of
each attention kernel call and the least bytes of the optimizer. A model's
operations a step are its family's (`benchmark/families/<family>.py`), by
the same rules.

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


def visible_pairs(sq: int, sk: int, causal: bool = True) -> int:
    """(query, key) pairs a causal mask leaves, query i seeing keys 0..i."""
    if not causal:
        return sq * sk
    n = min(sq, sk)
    return n * (n + 1) // 2 + (sq - n) * sk


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


def adamw_least_bytes(n_params: int) -> int:
    """Least bytes that the step moves after the backward on f32 parameters,
    gradients and moments: the global norm reads g once; clip and AdamW read
    g, p, mu and nu and write p, mu and nu. 8 x 4 bytes a parameter."""
    return 32 * n_params
