"""Model families of the training kind, one module each, found by the
configuration's `"family"` (`"dense"` where the key is absent) as
`benchmark/families/<family>.py`. A family module gives:

- `program_config(m, cell, fixed)`: the program's config for configuration
  `m` under the cell's traffic and program settings;
- `leaves(m)`: the trained weights as (path, shape, init scale; None for a
  norm's ones), in the order `inputs.iter_params` draws them;
- `fixed(m, seed, device)` (optional): tensors that are not trained, each
  drawn from `inputs.derive(seed, ...)` with a tag of the family's own; the
  program's config and the reference both receive them;
- `forward(params, tokens, m, *, fixed, quant, remat)`: the plain float32
  reference's logits, in `reference.py`'s terms;
- `train_flops_per_token(m, seq)`: the operations a token's forward and
  backward need (`counts.py`'s rules);
- `attention_shape(m, traffic)`: b, s, h, hkv, d of the attention kernels'
  calls and the number of attention layers, for the flash readers;
- `TINY`: the keys that cut it to a size the CPU tests run.
"""
