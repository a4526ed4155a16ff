"""Self-speculative decoding: the n-gram / prompt-lookup draft proposer —
a copy of ``repro/serve/spec.py``.

No draft model.  A slot's own token history (prompt + everything it has
generated) is the proposal source: if the most recent n-gram has occurred
before, the tokens that followed that occurrence become the draft — the
prompt-lookup idiom.  Greedy LMs are repetitive (prompts quote earlier
text, outputs fall into argmax cycles), so the lookup is cheap and often
right; when it is wrong, the batched verify step
(:func:`repro_torch.models.transformer.decode_verify_paged`) rejects the
disagreeing suffix and the run degrades to ordinary one-token decode —
never to a wrong token, because acceptance only keeps draft tokens the
model's own argmax reproduces.

Everything here is host-side numpy over python ints — the scheduler calls
it between device steps, so speculation adds no device work when no
draft is found.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

SPEC_MODES = ("off", "ngram")

# longest recent-suffix n-gram tried for a history match, backing off to 1
DEFAULT_MAX_NGRAM = 3


def propose_ngram(hist: Sequence[int], max_draft: int,
                  max_ngram: int = DEFAULT_MAX_NGRAM) -> List[int]:
    """Draft up to ``max_draft`` tokens by prompt-lookup over ``hist``
    (the slot's prompt + generated ids, oldest first — the last entry is
    the token the next decode step will consume).

    Tries the longest recent suffix first (``max_ngram`` down to 1): the
    MOST RECENT earlier occurrence of that suffix wins and the tokens
    that followed it become the draft.  Returns [] when the history is
    too short or nothing matches — the scheduler then falls back to the
    plain one-token decode step."""
    h = np.asarray(hist, dtype=np.int64)
    L = h.shape[0]
    if L < 2 or max_draft <= 0:
        return []
    for n in range(min(max_ngram, L - 1), 0, -1):
        pat = h[L - n:]
        # candidate windows strictly before the suffix itself, so the
        # continuation has at least one token to offer
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.flatnonzero((windows == pat).all(axis=1))
        if hits.size:
            j = int(hits[-1])                   # most recent occurrence
            cont = h[j + n: j + n + max_draft]
            if cont.size:
                return [int(t) for t in cont]
    return []


def accept_length(draft: Sequence[int], outs: Sequence[int]) -> int:
    """Longest agreeing prefix: how many draft tokens the verify step's
    argmax row-by-row reproduced.  ``outs[j]`` is the model's next token
    after consuming the committed token plus ``draft[:j]`` — accepting
    while ``draft[j] == outs[j]`` makes the emitted stream
    ``draft[:acc] + [outs[acc]]``, identical to sequential greedy
    decode."""
    acc = 0
    for j, d in enumerate(draft):
        if j >= len(outs) or int(outs[j]) != int(d):
            break
        acc += 1
    return acc
