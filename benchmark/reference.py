"""The plain reference: a model's loss, gradients, clipping and AdamW in
float32 PyTorch with TF32 off, written from the published model
description and the optimizer's definition, with no kernel, cache, batching
or anything of the program under test. Each model family's forward
(`benchmark/families/<family>.py`) is written from the pieces here.

It takes the weights and tokens that `benchmark/inputs.py` makes from the
seed, and the configuration's numbers, and nothing the program has made.
`quant="fp8"` computes every matmul from operands rounded to float8 e4m3
(per-tensor scale): the control, one precision below the bf16 compute the
configurations state, that the checks must fail.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact_float32() -> None:
    """Matmuls in full float32: a TF32 product would round its inputs to 10
    bits of mantissa."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rounded(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown precision {quant!r}")
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    # The rounding is the forward's; gradients pass straight through it.
    return x + (q - x).detach()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate each interleaved pair (x[2i], x[2i+1]) of [B, S, H, D] by
    position * theta^(-2i/D)."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).flatten(-2)


def attention(q, k, v, quant: Optional[str]) -> torch.Tensor:
    """Causal softmax attention over [B, S, H, D]; GQA by repeating each kv
    head for its group of consecutive q heads."""
    h, s = q.shape[2], q.shape[1]
    k = k.repeat_interleave(h // k.shape[2], dim=2)
    v = v.repeat_interleave(h // v.shape[2], dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", rounded(q, quant), rounded(k, quant))
    scores = scores * q.shape[-1] ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", rounded(p, quant), rounded(v, quant))


def mm(eq: str, x, w, quant: Optional[str]) -> torch.Tensor:
    """The product `eq` of an activation and a weight, each rounded."""
    return torch.einsum(eq, rounded(x, quant), rounded(w, quant))


def _flatten(tree: Dict, prefix=()) -> Dict[tuple, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: Dict[tuple, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def train(params0: Dict, batches: List[Dict], m: dict, opt: dict, forward: Callable, *,
          quant: Optional[str] = None, rows: Optional[int] = None) -> Dict:
    """The training steps on `batches` from the float32 weights `params0`
    (left as they are), `forward(tree, tokens, m, quant=, remat=)` giving
    the logits: per step the mean next-token cross entropy over the
    batch's tokens, its gradient (one row at a time, each layer recomputed
    in the backward, accumulated), clip_by_global_norm, then AdamW in
    optax's order (scale_by_adam, add_decayed_weights, -lr).

    `rows` takes the first rows of each batch only (a planted fault).
    Returns each step's loss, each leaf's clipped first gradient norm, and
    each leaf's change over all steps, by leaf path."""
    flat0 = _flatten(params0)
    params = {p: t.detach().clone().requires_grad_(True) for p, t in flat0.items()}
    mu = {p: torch.zeros_like(t) for p, t in flat0.items()}
    nu = {p: torch.zeros_like(t) for p, t in flat0.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    losses, first_grad = [], {}
    for step, batch in enumerate(batches, start=1):
        tokens, targets = batch["tokens"], batch["targets"]
        n = rows or tokens.shape[0]
        tree = _unflatten(params)
        loss_sum = 0.0
        for r in range(n):
            logits = forward(tree, tokens[r:r + 1], m, quant=quant, remat=True)
            loss = torch.nn.functional.cross_entropy(
                logits.flatten(0, 1), targets[r:r + 1].flatten().long())
            (loss / n).backward()
            loss_sum += loss.item()
            del logits, loss
        losses.append(loss_sum / n)
        with torch.no_grad():
            grads = {p: t.grad for p, t in params.items()}
            norm = math.sqrt(sum(_norm(g) ** 2 for g in grads.values()))
            clip = opt["clip_norm"] / max(norm, opt["clip_norm"])
            for p, t in params.items():
                g = grads[p] * clip
                if step == 1:
                    first_grad[p] = _norm(g)
                mu[p].mul_(b1).add_(g, alpha=1 - b1)
                nu[p].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[p] / (1 - b1 ** step)) / ((nu[p] / (1 - b2 ** step)).sqrt() + eps)
                t.sub_((upd + opt["weight_decay"] * t) * opt["learning_rate"])
                t.grad = None
    with torch.no_grad():
        change = {p: _norm(t - flat0[p]) for p, t in params.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change}
