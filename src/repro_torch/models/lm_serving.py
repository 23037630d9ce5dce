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

``greedy_generate`` also serves a dense or MoE model placed on a mesh
(``launch.inputs.place_params``), called on every rank under
``use_mesh``: it places the prompt by the batch rule and its fresh caches
by ``decode_state_specs`` (``launch.inputs.place_cache``), and takes the
greedy token from vocabulary-cut logits by each rank's local maximum,
gathered, so that every rank feeds the same whole tokens to the next
step.  ``ServeEngine`` has no mesh path, as the reference's has none.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (
    block_start,
    current_mesh,
    current_rules,
)
from repro_torch.launch.inputs import (
    batch_shardings,
    place_cache,
    serving_shardings,
)
from repro_torch.models import decode_step, init_decode_state, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LM, serving


def greedy_tokens(logits):
    """The greedy tokens [B, 1] int32 of logits [B, V]: the first largest
    entry of each row, as ``torch.argmax``.  Logits placed on a mesh give
    whole tokens, the same on every rank: each rank's first largest entry
    of its block of the vocabulary, with its value, is gathered (with the
    batch's blocks), and the first block holding the row's largest value
    names the token."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    local = logits.to_local()
    idx = torch.argmax(local, dim=-1, keepdim=True)
    pair = torch.cat([local.gather(-1, idx).to(torch.float64),
                      (idx + block_start(logits, 1)).to(torch.float64)],
                     dim=-1)[:, None, :]
    mesh, pl = logits.device_mesh, logits.placements
    blocks = math.prod(n for n, p in zip(mesh.shape, pl) if p.is_shard(1))
    whole = DTensor.from_local(
        pair, mesh, pl, run_check=False, shape=(logits.shape[0], blocks, 2),
        stride=(2 * blocks, 2, 1)).full_tensor()
    best = torch.argmax(whole[..., 0], dim=-1, keepdim=True)
    return whole[..., 1].gather(-1, best).to(torch.int32)


@serving
def greedy_generate(model: LM, cfg: ModelConfig, prompts: np.ndarray,
                    max_new_tokens: int, extra: dict | None = None):
    """prompts: [B, S_prompt] int32.  Returns [B, max_new_tokens] numpy;
    ``extra`` adds batch entries (``image_embeds``) as tensors.  Under
    ``use_mesh`` with a placed model, every rank calls it with the same
    prompts and gets the same tokens."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
    dev = model.final_norm.device
    b, s = prompts.shape
    cache = init_decode_state(cfg, b, s + max_new_tokens, dev)
    batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                       device=dev)}
    if extra:
        batch.update(extra)
    mesh = current_mesh()
    if mesh is not None:
        _, shardings = serving_shardings(cfg, mesh, b, s + max_new_tokens,
                                         current_rules())
        cache = place_cache(cache, shardings)
        batch = {k: sh.distribute(batch[k])
                 for k, sh in batch_shardings(mesh, batch).items()}
    logits, cache = prefill(model, cfg, batch, cache)
    toks = [greedy_tokens(logits)]
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(model, cfg, toks[-1], cache)
        toks.append(greedy_tokens(logits))
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
        cur = greedy_tokens(logits)
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
            cur = greedy_tokens(logits)
        return outs
