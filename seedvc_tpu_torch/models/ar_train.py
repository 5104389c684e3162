"""AR training loss: packed-sequence cross-entropy (port of
``seedvc_tpu/models/ar_train.py``).

Each sample's valid region is ``[sep, cond[0..cl), sep, emb(x[0..xl))]``
with the second sep at index cl + 1:

- RoPE positions restart at the second sep;
- ``x`` is padded with EOS beyond its length before embedding;
- labels: position p in [cl + 1, cl + xl] predicts x[p - (cl + 1)] (the
  second sep predicts x[0]), position cl + xl + 1 predicts EOS, every other
  position is ignored;
- the log-softmax is taken in f32 and the loss is the mean over the valid
  labels (of the whole batch: inside a ``set_mesh`` block whose batch is
  split over ``data``, this rank's share of it, whose mean over the ranks
  is the global batch's mean).

The AR's attention is its own ``_bmm_f32`` path (the JAX AR has no Pallas
kernel); under autograd it runs in f32 as the forward does.
"""

from __future__ import annotations

import torch

from seedvc_tpu_torch.models.ar import ARTransformer
from seedvc_tpu_torch.parallel.collectives import all_reduce_sum
from seedvc_tpu_torch.parallel.mesh import batch_split

IGNORE = -100


def ar_loss(model: ARTransformer, cond_emb: torch.Tensor, cond_lens: torch.Tensor,
            targets: torch.Tensor, target_lens: torch.Tensor) -> torch.Tensor:
    """cond_emb: (B, C_max, D) regulated narrow-token embeddings; cond_lens:
    (B,); targets: (B, X_max) wide tokens; target_lens: (B,). Returns the
    mean cross-entropy over the valid labels."""
    eos = model.cfg.eos
    B, C_max, D = cond_emb.shape
    X_max = targets.shape[1]
    L = 2 + C_max + X_max
    dev = cond_emb.device
    cond_lens, target_lens = cond_lens.long(), target_lens.long()
    idx = torch.arange(L, device=dev)[None, :]
    second_sep = (cond_lens + 1)[:, None]

    pos_x = torch.arange(X_max, device=dev)[None, :]
    x_tok = torch.where(pos_x < target_lens[:, None], targets.long(),
                        torch.full_like(targets, eos, dtype=torch.long))
    tok_emb = model.embed_tokens(x_tok)

    cond_at = torch.clamp(idx - 1, 0, C_max - 1).expand(B, L)
    tok_at = torch.clamp(idx - second_sep - 1, 0, X_max - 1)
    is_sep = (idx == 0) | (idx == second_sep)
    gathered = torch.where((idx < second_sep)[..., None],
                           torch.gather(cond_emb, 1, cond_at[..., None].expand(B, L, D)),
                           torch.gather(tok_emb, 1, tok_at[..., None].expand(B, L, D)))
    emb = torch.where(is_sep[..., None], model.sep_token_emb.to(gathered.dtype), gathered)

    pos = torch.where(idx <= cond_lens[:, None], idx, idx - second_sep)
    valid_len = (2 + cond_lens + target_lens)[:, None]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None, None]
    mask = causal & (idx < valid_len)[:, None, None, :]

    logits = model(emb, pos, mask)  # (B, L, vocab)

    tgt_region = (idx >= second_sep) & (idx < second_sep + target_lens[:, None])
    eos_pos = idx == second_sep + target_lens[:, None]
    shift = torch.clamp(idx - second_sep, 0, X_max - 1)
    labels = torch.where(tgt_region, torch.gather(x_tok, 1, shift),
                         torch.where(eos_pos, torch.full_like(shift, eos),
                                     torch.full_like(shift, IGNORE)))
    valid = labels != IGNORE
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    split = batch_split()
    if split is None:
        return (nll * valid).sum() / torch.clamp(valid.sum(), min=1)
    mesh, axis = split
    count = all_reduce_sum(valid.sum(), mesh.group(axis))
    return (nll * valid).sum() * mesh.size(axis) / torch.clamp(count, min=1)
