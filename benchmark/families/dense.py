"""The dense decoder (InternLM2, Llama and their kin): GQA attention with
RoPE and a SwiGLU feed-forward in every layer, RMSNorm before each,
separate output head unless tied.

Weights in the program's layout: wq [L, d, H, hd], wo [L, H, hd, d], RoPE
on interleaved pairs, a kv head shared by H / KV consecutive q heads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from benchmark import counts
from benchmark.reference import attention, mm, rms_norm, rope

# Wide enough that bf16's error in the compared numbers stays as far below
# the cells' limits, and fp8's as far above, as at full size; small enough
# for the CPU.
TINY = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=32, intermediate_size=512, vocab_size=2048)


def program_config(m: dict, cell: dict, fixed: Optional[Dict] = None):
    from ray_tpu_torch.models.transformer import TransformerConfig

    spec, prog = m["train"], cell["program"]
    return TransformerConfig(
        vocab_size=m["vocab_size"], d_model=m["hidden_size"], n_layers=m["num_hidden_layers"],
        n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
        d_ff=m["intermediate_size"], max_seq_len=cell["traffic"]["seq"],
        rope_theta=float(m["rope_theta"]), norm_eps=m["rms_norm_eps"],
        dtype=getattr(torch, spec["dtype"]), param_dtype=getattr(torch, spec["param_dtype"]),
        tie_embeddings=m["tie_word_embeddings"], remat=prog["remat_policy"] != "off",
        remat_policy=None if prog["remat_policy"] in ("full", "off") else prog["remat_policy"],
    )


def leaves(m: dict):
    """(path, shape, scale) of every weight in the port's layout and the
    port's init scales: normal * d^-0.5, the output projections (2 L d)^-0.5;
    the norms are ones (scale None)."""
    d, L, hd = m["hidden_size"], m["num_hidden_layers"], m["head_dim"]
    h, kv, ff, v = (m["num_attention_heads"], m["num_key_value_heads"],
                    m["intermediate_size"], m["vocab_size"])
    s, out = d ** -0.5, (2 * L * d) ** -0.5
    return [
        (("embed", "tokens"), (v, d), s),
        (("layers", "attn", "wq"), (L, d, h, hd), s),
        (("layers", "attn", "wk"), (L, d, kv, hd), s),
        (("layers", "attn", "wv"), (L, d, kv, hd), s),
        (("layers", "attn", "wo"), (L, h, hd, d), out),
        (("layers", "mlp", "w_gate"), (L, d, ff), s),
        (("layers", "mlp", "w_up"), (L, d, ff), s),
        (("layers", "mlp", "w_down"), (L, ff, d), out),
        (("layers", "ln1"), (L, d), None),
        (("layers", "ln2"), (L, d), None),
        (("final_norm",), (d,), None),
        (("lm_head",), (d, v), s),
    ]


def layer(x: torch.Tensor, lp: Dict, m: dict, quant: Optional[str]) -> torch.Tensor:
    eps, theta = m["rms_norm_eps"], float(m["rope_theta"])
    h = rms_norm(x, lp["ln1"], eps)
    q = rope(mm("bse,ehd->bshd", h, lp["wq"], quant), theta)
    k = rope(mm("bse,ehd->bshd", h, lp["wk"], quant), theta)
    v = mm("bse,ehd->bshd", h, lp["wv"], quant)
    x = x + mm("bshd,hde->bse", attention(q, k, v, quant), lp["wo"], quant)
    h = rms_norm(x, lp["ln2"], eps)
    ff = torch.nn.functional.silu(mm("bse,ef->bsf", h, lp["w_gate"], quant))
    ff = ff * mm("bse,ef->bsf", h, lp["w_up"], quant)
    return x + mm("bsf,fe->bse", ff, lp["w_down"], quant)


def _layer_params(params: Dict, i: int) -> Dict:
    """Layer i's weights in float32 (a bf16 tree is widened one layer at a
    time, so that only one layer's float32 copy lives)."""
    a, f = params["layers"]["attn"], params["layers"]["mlp"]
    out = {k: a[k][i] for k in ("wq", "wk", "wv", "wo")}
    out.update({k: f[k][i] for k in ("w_gate", "w_up", "w_down")})
    out.update(ln1=params["layers"]["ln1"][i], ln2=params["layers"]["ln2"][i])
    return {k: t.float() for k, t in out.items()}


def trunk(params: Dict, tokens: torch.Tensor, m: dict, *, quant: Optional[str] = None,
          remat: bool = False) -> torch.Tensor:
    """The final norm's output [B, S, d] of token ids [B, S]."""
    x = params["embed"]["tokens"][tokens].float()
    for i in range(m["num_hidden_layers"]):
        lp = _layer_params(params, i)
        if remat:
            x = checkpoint(layer, x, lp, m, quant, use_reentrant=False)
        else:
            x = layer(x, lp, m, quant)
    return rms_norm(x, params["final_norm"].float(), m["rms_norm_eps"])


def forward(params: Dict, tokens: torch.Tensor, m: dict, *, fixed: Optional[Dict] = None,
            quant: Optional[str] = None, remat: bool = False) -> torch.Tensor:
    """Logits [B, S, V] of token ids [B, S]."""
    x = trunk(params, tokens, m, quant=quant, remat=remat)
    return mm("...e,ev->...v", x, params["lm_head"].float(), quant)


def layer_matmul_params(m: dict) -> int:
    """Weights of one decoder layer that take part in a matmul: q, k, v and
    o projections and the three SwiGLU matrices."""
    d, hd = m["hidden_size"], m["head_dim"]
    attn = d * hd * (2 * m["num_attention_heads"] + 2 * m["num_key_value_heads"])
    return attn + 3 * d * m["intermediate_size"]


def matmul_params(m: dict) -> int:
    """N_nonemb: every weight that a token's forward multiplies, the output
    head included and the embedding table (a lookup) left out."""
    return m["num_hidden_layers"] * layer_matmul_params(m) + m["hidden_size"] * m["vocab_size"]


def attention_forward_flops(m: dict, seq: int) -> int:
    """QK^T and PV over the visible pairs of one sequence, every layer."""
    heads = m["num_attention_heads"]
    return m["num_hidden_layers"] * 4 * heads * m["head_dim"] * counts.visible_pairs(seq, seq)


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward of one token of a [*, seq] batch: 6 N_nonemb,
    and three times the causal attention products (6 L d S / 2 per token on
    average, exactly as the visible pairs give it)."""
    return 6 * matmul_params(m) + 3 * attention_forward_flops(m, seq) / seq


def attention_shape(m: dict, traffic: dict) -> dict:
    return {"b": traffic["batch"], "s": traffic["seq"], "h": m["num_attention_heads"],
            "hkv": m["num_key_value_heads"], "d": m["head_dim"],
            "layers": m["num_hidden_layers"]}
