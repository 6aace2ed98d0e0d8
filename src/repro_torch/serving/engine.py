"""Batched serving engine: prefill + greedy/sampled decode.

Port of `repro.serving.engine`.  Two cache back-ends:
  dense : the model's native stacked cache (`models.registry.decode_step`).
  strap : StrapCache-gated attention for the full-attention decoder
          families (dense, vlm) — the paper-technique path, whose
          attention runs in the CUDA kernel
          `kernels/csrc/strap_attend.cu` on the card.  In exact mode
          (top_straps=0) it matches dense decode to numerical tolerance;
          gated mode trades bounded attention error for an HBM-traffic
          reduction reported by `stats`.

The engine runs on `device` (default "cuda"; it raises without a GPU
unless `device="cpu"`) and its params must already lie there.  Caches are
updated in place.  The MoE, SSM and hybrid configs serve on the dense
backend; the strap backend refuses them, as the reference does.  An
enc-dec config (Whisper) is refused: the engine's prefill takes token
ids only, with no encoder embeddings; it runs through
`models.registry.prefill` / `decode_step`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..memory.strap_cache import StrapCacheConfig, StrapKVCache
from ..models import registry as M
from ..models.attention import _project_qkv
from ..models.common import (apply_norm, apply_rope, embed_tokens, lm_logits,
                             torch_dtype)
from ..models.lm import ffn_apply, layer_params

BACKENDS = ("dense", "strap")


@dataclass
class ServeStats:
    tokens_decoded: int = 0
    hbm_bytes_gated: int = 0
    hbm_bytes_dense: int = 0

    @property
    def traffic_reduction(self) -> float:
        if not self.hbm_bytes_dense:
            return 1.0
        return self.hbm_bytes_gated / self.hbm_bytes_dense


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, max_tokens: int = 2048,
                 cache_backend: str = "dense",
                 strap_cfg: StrapCacheConfig | None = None, device="cuda"):
        if cache_backend not in BACKENDS:
            raise ValueError(f"cache_backend {cache_backend!r}; expected one "
                             f"of {BACKENDS}")
        if cfg.is_encdec:
            # the reference's engine fails here with a KeyError: its
            # prefill passes no `enc_embeds`
            raise ValueError(
                f"{cfg.name}: the engine serves decoder-only configs; its "
                "prefill passes no encoder embeddings (`enc_embeds`), so an "
                "enc-dec config runs through models.registry.prefill and "
                "decode_step")
        if cache_backend == "strap" and cfg.family not in ("dense", "vlm"):
            raise ValueError(
                "strap cache applies to full-attention decoder families")
        self.device = resolve_device(device)
        if not _on_device(params["embed"], self.device):
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_tokens = max_tokens
        self.backend = cache_backend
        self.strap_cfg = strap_cfg or StrapCacheConfig()
        self.stats = ServeStats()
        self._cache = None
        self._pos = None
        self._n_tokens = 0           # tokens held per sequence (host copy)
        self._last_logits = None

    def _tokens(self, tokens) -> torch.Tensor:
        """Token ids (a tensor, numpy array or nested list) as int32 on the
        engine's device."""
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.array(tokens, np.int32))
        return tokens.to(device=self.device, dtype=torch.int32)

    # ------------------------------------------------------------------
    def prefill(self, tokens):
        """Run the (B, S) prompt; returns the last token's (B, V) logits."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        b, s = tokens.shape
        if s > self.max_tokens:
            raise ValueError(f"prompt of {s} tokens exceeds max_tokens="
                             f"{self.max_tokens}")
        logits, cache = M.prefill(cfg, self.params, {"tokens": tokens})
        self._pos = torch.full((b,), s, dtype=torch.int32, device=self.device)
        self._n_tokens = s
        if self.backend == "dense":
            # grow the seq axis of the K/V to max_tokens; an SSM or conv
            # state has no seq axis and keeps its shape
            pad = self.max_tokens - s
            self._cache = {k: (torch.nn.functional.pad(
                x, (0, 0, 0, 0, 0, pad)) if k in ("k", "v") and x.ndim == 5
                else x) for k, x in cache.items()}
        else:
            self._cache = [
                StrapKVCache.create(self.strap_cfg, b, self.max_tokens,
                                    cfg.n_kv_heads, cfg.head_dim_,
                                    cache["k"].dtype, self.device)
                .bulk_load(cache["k"][layer], cache["v"][layer])
                for layer in range(cfg.n_layers)]
        self._last_logits = logits
        return logits

    # ------------------------------------------------------------------
    def _decode_strap(self, token):
        """Per-layer decode using StrapCache gated attention."""
        cfg = self.cfg
        p = self.params
        dtype = torch_dtype(cfg.compute_dtype)
        h = embed_tokens(p, token, dtype)
        pos = self._pos
        for li in range(cfg.n_layers):
            lp = layer_params(p, li)
            a_in = apply_norm(cfg, h, lp, "ln1")
            q, k_new, v_new = _project_qkv(cfg, lp, a_in)
            if cfg.rope_theta > 0:
                q = apply_rope(q, pos[:, None], cfg.rope_theta)
                k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
            sc = self._cache[li].append(k_new[:, 0], v_new[:, 0])
            o = sc.attend(q[:, 0])                       # (B, Hq, hd)
            gated, dense = sc.hbm_bytes_per_token()
            self.stats.hbm_bytes_gated += gated
            self.stats.hbm_bytes_dense += dense
            attn = o.reshape(o.shape[0], 1, -1).to(dtype) @ lp["wo"]
            h = h + attn
            m_in = apply_norm(cfg, h, lp, "ln2")
            h = h + ffn_apply(cfg, lp, m_in)
        h = apply_norm(cfg, h, p, "final")
        return lm_logits(cfg, p, h)[:, 0]

    def step(self, token=None, greedy: bool = True,
             generator: torch.Generator | None = None):
        """Decode one token for the whole batch; returns ((B, 1) ids, (B, V)
        logits).  With `token=None` the next token is taken from the last
        logits: their argmax, or a sample drawn with `generator` when
        `greedy=False` (argmax when no generator is given, as the
        reference does without a key)."""
        if self._n_tokens >= self.max_tokens:
            raise ValueError(f"the cache is full ({self.max_tokens} tokens)")
        if token is None:
            logits = self._last_logits
            if greedy or generator is None:
                token = torch.argmax(logits, dim=-1)
            else:
                token = torch.multinomial(torch.softmax(logits.float(), -1),
                                          1, generator=generator)[:, 0]
            token = token[:, None].to(torch.int32)
        else:
            token = self._tokens(token)
        if self.backend == "dense":
            logits, self._cache = M.decode_step(
                self.cfg, self.params, self._cache, token, self._pos)
        else:
            logits = self._decode_strap(token)
        self._pos = self._pos + 1
        self._n_tokens += 1
        self._last_logits = logits
        self.stats.tokens_decoded += int(token.shape[0])
        return token, logits

    def generate(self, tokens, n_new: int, greedy: bool = True):
        """Prefill the (B, S) prompt and decode `n_new` tokens -> (B, n_new)
        int32 ids."""
        self.prefill(tokens)
        out = []
        tok = None
        for _ in range(n_new):
            tok, _ = self.step(tok, greedy=greedy)
            out.append(tok)
        return torch.cat(out, dim=1)
