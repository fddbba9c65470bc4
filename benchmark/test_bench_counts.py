"""The yardstick's arithmetic against values worked out by hand: the peaks
and bounds of `counts.py`, and the dense family's operations a token."""

import pytest

from benchmark import counts, manifest
from benchmark.families import dense

H100 = counts.PEAKS["NVIDIA H100 80GB HBM3"]


def test_internlm2_train_flops_by_hand():
    m = manifest.config("internlm2-1.8b")
    layer = 2048 * 128 * (2 * 16 + 2 * 8) + 3 * 2048 * 8192
    assert layer == 62_914_560
    n = 24 * layer + 2048 * 92544
    assert dense.matmul_params(m) == n == 1_699_479_552
    # Causal attention: 4 * H * hd flops a visible pair, 4096 * 4097 / 2 pairs
    # a sequence, three passes (forward, two in the backward), per token.
    attn = 3 * 24 * 4 * 16 * 128 * (4096 * 4097 // 2) / 4096
    assert dense.train_flops_per_token(m, 4096) == pytest.approx(6 * n + attn, rel=1e-12)
    assert dense.train_flops_per_token(m, 4096) == pytest.approx(11.405131776e9, rel=1e-9)


def test_parameter_count_is_the_published_one():
    m = manifest.config("internlm2-1.8b")
    d, L = m["hidden_size"], m["num_hidden_layers"]
    embed, norms = d * m["vocab_size"], d * (2 * L + 1)
    assert dense.matmul_params(m) + embed + norms == m["parameters"]


def test_flash_bounds_by_hand():
    b, s, h, hkv, d = 4, 4096, 16, 8, 128
    pairs = s * (s + 1) // 2
    fwd = max(4 * d * pairs * b * h / 989e12,
              ((2 * b * s * h * d + 2 * b * s * hkv * d) * 2 + b * h * s * 4) / 3.35e12)
    assert counts.flash_fwd_bound_s(b, s, h, hkv, d, H100) == pytest.approx(fwd, rel=1e-12)
    product = 2 * d * pairs * b * h
    q, kv = b * s * h * d * 2, b * s * hkv * d * 2
    reads = 2 * q + 2 * kv + 2 * b * h * s * 4
    # S, dP, dV, dK, dQ: five products; each input read and each gradient
    # written once.
    bwd = (max(5 * product / 989e12, (reads + q + 2 * kv) / 3.35e12)
           + max(2 * b * s * h * d / 989e12, (2 * q + b * h * s * 4) / 3.35e12))
    assert counts.flash_bwd_bound_s(b, s, h, hkv, d, H100) == pytest.approx(bwd, rel=1e-12)


def test_visible_pairs():
    assert counts.visible_pairs(4, 4) == 10
    assert counts.visible_pairs(3, 5, causal=False) == 15


def test_an_unknown_card_has_no_peak():
    with pytest.raises(RuntimeError, match="no published peak"):
        counts.peak("NVIDIA A100-SXM4-80GB")


def test_adamw_least_bytes_by_hand():
    # |g| once for the norm; g, p, mu, nu read and p, mu, nu written: 8 f32.
    assert counts.adamw_least_bytes(1) == 8 * 4
    assert counts.adamw_least_bytes(1_889_110_016) / 3.35e12 == pytest.approx(18.05e-3, rel=1e-3)
