"""LM batched serving: one prefill per wave, then greedy decode steps.

The port of the JAX package's ``models/lm_serving.py``.  ``ServeEngine``
owns a fixed batch of request slots: a wave left-pads its prompts with
token 0 to a common length (the padded positions are attended, and
ingested by a recurrent state, as in the reference), runs one batched
prefill and then single-token decode steps until every slot has reached
EOS or the budget; the same loop serves every family.  Each step's
tokens come back to the host in one copy.  Neither loop runs the decode
step whose logits the reference computes after the last token and never
reads, so a wave runs one step fewer; the tokens are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM


def _argmax(logits):
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


@torch.inference_mode()
def greedy_generate(model: LM, cfg: ModelConfig, prompts: np.ndarray,
                    max_new_tokens: int, extra: dict | None = None):
    """prompts: [B, S_prompt] int32.  Returns [B, max_new_tokens] numpy;
    ``extra`` adds batch entries (``image_embeds``) as tensors."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
    dev = model.final_norm.device
    b, s = prompts.shape
    cache = init_decode_state(cfg, b, s + max_new_tokens, dev)
    batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                       device=dev)}
    if extra:
        batch.update(extra)
    logits, cache = prefill(model, cfg, batch, cache)
    toks = [_argmax(logits)]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(model, cfg, toks[-1], cache)
        toks.append(_argmax(logits))
    return torch.cat(toks, dim=1).cpu().numpy()


@dataclasses.dataclass
class ServeEngine:
    """Fixed-slot, wave-synchronous batched serving on the model's device.

    Requests queue up; ``run_wave`` serves up to ``n_slots`` of them to
    completion and returns ``{request_id: generated tokens}``."""

    model: LM
    cfg: ModelConfig
    n_slots: int
    max_len: int

    def __post_init__(self):
        self._queue: list[tuple[int, np.ndarray]] = []
        self._next_req = 0

    def submit(self, prompt: np.ndarray) -> int:
        rid = self._next_req
        self._next_req += 1
        self._queue.append((rid, np.asarray(prompt, np.int32)))
        return rid

    @torch.inference_mode()
    def run_wave(self, eos: int | None = None, max_tokens: int = 64):
        if not self._queue:
            return {}
        dev = self.model.final_norm.device
        wave = self._queue[:self.n_slots]
        self._queue = self._queue[self.n_slots:]
        plen = max(len(p) for _, p in wave)
        toks = np.zeros((self.n_slots, plen), np.int32)
        for i, (_, p) in enumerate(wave):
            toks[i, plen - len(p):] = p  # left-pad into the slot
        cache = init_decode_state(self.cfg, self.n_slots, self.max_len, dev)
        logits, cache = prefill(self.model, self.cfg,
                                {"tokens": torch.as_tensor(toks, device=dev)},
                                cache)
        cur = _argmax(logits)
        outs: dict[int, list[int]] = {rid: [] for rid, _ in wave}
        live = np.ones(len(wave), bool)
        for step in range(max_tokens):
            host = cur[:, 0].tolist()  # the step's one device-to-host copy
            for i, (rid, _) in enumerate(wave):
                if live[i]:
                    outs[rid].append(host[i])
                    if eos is not None and host[i] == eos:
                        live[i] = False
            if not live.any() or step == max_tokens - 1:
                break
            logits, cache = decode_step(self.model, self.cfg, cur, cache)
            cur = _argmax(logits)
        return outs
