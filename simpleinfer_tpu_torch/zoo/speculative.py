"""Draft-model speculative decoding (greedy, lossless): the counterpart
of simpleinfer_tpu/zoo/speculative.py.

A DRAFT model proposes k - 1 tokens a round (one decode_block of k
steps); the TARGET scores all k positions in one decode_chunk_verify
pass. The longest draft prefix matching the target's own greedy tokens
is accepted, plus the target's token at the first mismatch, so the
output is the target's greedy stream through its verify path, whatever
the draft proposes.

Rejected proposals cost nothing to roll back: the caches are
position-indexed, entries past a row's position are never read before
an accepted token overwrites them, so a rejected suffix leaves stale
entries behind in both caches.

The round loop waits for the host (acceptance decides the next feed):
each round fetches the draft's proposals and the target's tokens.
"""
from __future__ import annotations

import numpy as np

from .generate import CachedDecoder


class SpeculativeDecoder:
    """Greedy speculative decoding over two causal-LM engines.

    target_engine / draft_engine: engines of one vocabulary (the draft's
    proposals index the target's). k: tokens a round (k - 1 proposals
    and the target's bonus token). Acceptance is per row, so a batch
    mixes rows at different depths.

    The draft decodes on scratch blocks through the per-row decode kernel
    (kernels/decode_attn.decode_attention) where its
    CachedDecoder.kernel_ok allows it, GenerationService's rule under
    decode_attn="auto"; sliding, softcapped and ALiBi drafts attend on
    torch. The route moves the draft's proposals by summation order only,
    so the output is the target's greedy stream either way.

        spec = SpeculativeDecoder(target_eng, draft_eng, k=4)
        out = spec.generate(prompt_ids, steps=64, eos_id=2)
        spec.stats  # rounds / drafted / accepted
    """

    def __init__(self, target_engine, draft_engine, k: int = 4,
                 kv_dtype: str | None = None,
                 scratch_blocks: bool = False):
        if k < 2:
            raise ValueError(f"k must be >= 2 (one draft token + the "
                             f"bonus), got {k}")
        self.k = int(k)
        self.target = CachedDecoder(target_engine, kv_dtype=kv_dtype,
                                    scratch_blocks=scratch_blocks)
        self.draft = CachedDecoder(draft_engine, scratch_blocks=True)
        self._draft_attn = "kernel" if self.draft.kernel_ok else "torch"
        if self.draft._window < self.target._window:
            raise ValueError(
                f"draft window {self.draft._window} must cover the "
                f"target window {self.target._window} (caches are "
                f"position-indexed)")
        self.stats = {"rounds": 0, "drafted": 0, "accepted": 0}

    @property
    def acceptance(self) -> float:
        return self.stats["accepted"] / max(1, self.stats["drafted"])

    def generate(self, prompt_ids, steps: int,
                 eos_id: int | None = None) -> np.ndarray:
        """Greedy-decode `steps` tokens after each prompt row: the
        target's greedy stream, in about steps / (1 + acceptance (k - 1))
        rounds.

        prompt_ids: [N, P]; returns [N, P + emitted] int64 (rows frozen
        after eos_id when given, as CachedDecoder.generate)."""
        prompt = np.asarray(prompt_ids)
        n, p = prompt.shape
        if p + steps > self.target._window:
            raise ValueError(f"prompt ({p}) + steps ({steps}) exceeds "
                             f"the target window {self.target._window}")
        k = self.k
        zeros = np.zeros(n, np.float32)
        izeros = np.zeros(n, np.int64)
        ones = np.ones(n, np.float32)

        # prefill both models on the prompt; the target's greedy token is
        # the first accepted one
        lengths = np.full(n, p)
        window = np.zeros((n, self.target._window), np.float32)
        window[:, :p] = prompt
        t0, t_cache = self.target.prefill_sample(
            window, lengths, 0, 0, zeros, izeros, ones)
        d_win = np.zeros((n, self.draft._window), np.float32)
        d_win[:, :p] = prompt
        _, d_cache = self.draft.prefill_sample(
            d_win, lengths, 0, 0, zeros, izeros, ones)

        total = p + steps
        buf = np.zeros((n, total), np.int64)
        buf[:, :p] = prompt
        cur = np.full(n, p, np.int64)     # next index to fill, per row
        buf[np.arange(n), np.minimum(cur, total - 1)] = t0.cpu().numpy()
        done = np.zeros(n, bool)
        if eos_id is not None:
            done |= buf[np.arange(n), cur] == eos_id
        cur += 1

        while True:
            live = ~done & (cur < total)
            if not live.any():
                break
            # each row's last accepted token and its position (finished
            # rows decode garbage that is discarded)
            last_idx = np.minimum(cur - 1, total - 1)
            last_tok = buf[np.arange(n), last_idx]
            pos = last_idx

            # 1) the draft's k steps: k - 1 proposals, and every position
            # a full acceptance reaches fed into its cache (no holes)
            d_toks, _d_last, d_cache = self.draft.decode_block(
                last_tok, pos, d_cache, 0, 1, zeros, izeros, ones, k,
                attn_impl=self._draft_attn)
            d_np = d_toks.cpu().numpy()                       # [N, k]

            # 2) the target verifies all k positions in one pass
            verify_in = np.concatenate(
                [last_tok[:, None], d_np[:, :k - 1]], axis=1)   # [N, k]
            g, t_cache = self.target.decode_chunk_verify(
                verify_in, pos, t_cache)
            g_np = g.cpu().numpy()                            # [N, k]

            # 3) per row: the longest draft prefix equal to the target's
            # greedy tokens, then the target's correction / bonus token
            self.stats["rounds"] += 1
            for i in range(n):
                if not live[i]:
                    continue
                emit = []
                # k - 1 proposals a round for a live row, whether or not
                # an early mismatch stops the scan
                self.stats["drafted"] += k - 1
                for j in range(k):
                    emit.append(int(g_np[i, j]))
                    if j < k - 1 and d_np[i, j] == g_np[i, j]:
                        self.stats["accepted"] += 1
                        continue
                    break
                for tok in emit:
                    if cur[i] >= total:
                        break
                    buf[i, cur[i]] = tok
                    cur[i] += 1
                    if eos_id is not None and tok == eos_id:
                        done[i] = True
                        break
                if cur[i] >= total:
                    done[i] = True

        if eos_id is None:
            return buf
        return buf[:, :int(cur.max())]
