"""Token sampling on the device: temperature / top-k / top-p (nucleus),
the counterpart of simpleinfer_tpu/zoo/sampling.py.

HF convention: logits are divided by the temperature, top-k keeps the k
highest-scoring tokens, top-p keeps the smallest prefix of the sorted
distribution whose cumulative mass reaches p (the first token always
survives), and the token is drawn from the renormalized survivors by
Gumbel-max. `temperature <= 0` is greedy argmax. The knobs are per-row,
so one step batch mixes greedy and sampled requests.

The noise comes from an explicit `torch.Generator` on the logits'
device. It cannot reproduce jax.random's stream, so sampled tokens
match the JAX package's in distribution, not token by token; greedy
rows match exactly. The JAX package's `cap` (top-k candidate cap) is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch


def all_greedy(temperature) -> bool:
    """True when `temperature` is a host array (or CPU tensor) with no
    row above 0: the draw is skipped without a device sync."""
    if isinstance(temperature, torch.Tensor):
        if temperature.device.type != "cpu":
            return False
        temperature = temperature.numpy()
    return bool(np.all(np.asarray(temperature) <= 0.0))


def sample_logits(logits, generator, temperature, top_k, top_p):
    """Sample one token per row.

    logits: [N, V] float; generator: a torch.Generator on the logits'
    device (unused when every row is greedy); temperature: [N] float
    (<= 0 means greedy); top_k: [N] int (0 means off); top_p: [N] float
    (1.0 means off). Returns [N] int64 token ids on the logits' device.
    """
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy(temperature):
        return greedy
    dev = logits.device
    n, v = logits.shape
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)

    # sort descending once; both filters are rank predicates on it
    sorted_l, order = torch.sort(logits, dim=-1, descending=True)
    scaled = sorted_l / torch.clamp(temperature, min=1e-6)[:, None]
    ranks = torch.arange(v, device=dev)[None, :]
    k_eff = torch.where(top_k > 0, top_k, v)[:, None]
    keep = ranks < k_eff
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose PRECEDING cumulative mass is < p: the smallest
    # prefix reaching p survives, and rank 0 always does
    keep &= (cum - probs) < top_p[:, None]
    masked = torch.where(keep, scaled, float("-inf"))
    u = torch.rand((n, v), generator=generator, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    choice = torch.argmax(masked + gumbel, dim=-1)           # sorted space
    sampled = torch.gather(order, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled)


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of decode step `step` of a stream seeded by `seed`:
    one seed per (seed, step), the counterpart of jax.random.fold_in, so
    a stream does not depend on how its steps are grouped into blocks."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return g
