"""StrapCache: the paper's Selector+Strap as a paged, gated KV cache.

Port of `repro.memory.strap_cache`.  Pages of `page_size` tokens are
grouped into straps of `pages_per_strap` pages.  At decode, a *selector*
picks which straps participate:

  exact mode : all straps selected (equal to dense attention)
  gated mode : top-k straps by selector score (summed-key dot query), the
               paper-analogue optimization — HBM traffic per token drops by
               the selectivity, like C_BL 20 fF -> 6.6 fF.

The compute path is `kernels.ops.strap_attend`: the CUDA kernel
`csrc/strap_attend.cu` on the card, which reads only the selected straps.

Unlike the reference (which returns a new cache), `bulk_load` and `append`
write the pages, key sums and length of this cache in place and return it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve_device
from ..kernels import ops


@dataclass
class StrapCacheConfig:
    page_size: int = 64
    pages_per_strap: int = 4
    top_straps: int = 0        # 0 = exact (all straps)

    @property
    def strap_tokens(self) -> int:
        return self.page_size * self.pages_per_strap


@dataclass
class StrapKVCache:
    """Paged KV storage for ONE layer: (B, P, page, Hkv, hd)."""
    cfg: StrapCacheConfig
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    length: torch.Tensor       # (B,) int32 tokens currently stored
    # selector metadata: running key sum per strap (B, S_straps, Hkv, hd)
    strap_key_sum: torch.Tensor

    @classmethod
    def create(cls, cfg: StrapCacheConfig, batch: int, max_tokens: int,
               n_kv: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda"):
        """An empty cache for `max_tokens` tokens (rounded up to whole
        straps) on `device` (default "cuda"; raises without a GPU unless
        `device="cpu"`)."""
        dev = resolve_device(device)
        p = -(-max_tokens // cfg.page_size)
        p = -(-p // cfg.pages_per_strap) * cfg.pages_per_strap
        straps = p // cfg.pages_per_strap
        shape = (batch, p, cfg.page_size, n_kv, head_dim)
        return cls(cfg=cfg,
                   k_pages=torch.zeros(shape, dtype=dtype, device=dev),
                   v_pages=torch.zeros(shape, dtype=dtype, device=dev),
                   length=torch.zeros((batch,), dtype=torch.int32, device=dev),
                   strap_key_sum=torch.zeros((batch, straps, n_kv, head_dim),
                                             dtype=torch.float32, device=dev))

    @property
    def n_straps(self) -> int:
        return self.k_pages.shape[1] // self.cfg.pages_per_strap

    def bulk_load(self, k: torch.Tensor, v: torch.Tensor) -> "StrapKVCache":
        """Load a prefill's (B, S, Hkv, hd) keys/values into the first pages
        (in place; the selector's key sums are recomputed from them)."""
        b, s, hkv, hd = k.shape
        ps, g = self.cfg.page_size, self.cfg.pages_per_strap
        if s > self.k_pages.shape[1] * ps:
            raise ValueError(f"bulk_load: {s} tokens exceed the cache's "
                             f"{self.k_pages.shape[1] * ps}")
        p_needed = -(-s // ps)
        # the touched pages are overwritten whole: prompt, then zero padding
        for pages, x in ((self.k_pages, k), (self.v_pages, v)):
            flat = pages.view(b, -1, hkv, hd)
            flat[:, :s] = x.to(pages.dtype)
            flat[:, s:p_needed * ps] = 0
        # strap selector metadata: float32 sums of the stored (cast) keys of
        # every strap the prompt touches
        straps_touched = -(-p_needed // g)
        kt = self.k_pages[:, : straps_touched * g].reshape(
            b, straps_touched, g * ps, hkv, hd)
        kt = kt.float().masked_fill(
            torch.arange(straps_touched * g * ps, device=k.device).reshape(
                1, straps_touched, g * ps, 1, 1) >= s, 0.0)
        self.strap_key_sum.zero_()
        self.strap_key_sum[:, :straps_touched] = kt.sum(dim=2)
        self.length = torch.full((b,), s, dtype=torch.int32, device=k.device)
        return self

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor) -> "StrapKVCache":
        """Append one token's (B, Hkv, hd) K/V (in place)."""
        b = k_new.shape[0]
        ps, g = self.cfg.page_size, self.cfg.pages_per_strap
        idx = self.length.long()                           # (B,)
        bidx = torch.arange(b, device=k_new.device)
        self.k_pages[bidx, idx // ps, idx % ps] = k_new.to(self.k_pages.dtype)
        self.v_pages[bidx, idx // ps, idx % ps] = v_new.to(self.v_pages.dtype)
        self.strap_key_sum[bidx, idx // (ps * g)] += k_new.float()
        self.length = self.length + 1
        return self

    # -- the selector -----------------------------------------------------
    def select_straps(self, q: torch.Tensor) -> torch.Tensor:
        """Choose strap ids per sequence: exact mode -> all valid straps;
        gated mode -> top-k by sum-key score, always incl. the newest strap.

        q: (B, Hq, hd).  Returns (B, S_sel) int32, -1 padded.
        """
        b = q.shape[0]
        n = self.n_straps
        tokens_per_strap = self.cfg.strap_tokens
        n_valid = (self.length + tokens_per_strap - 1) // tokens_per_strap
        all_ids = torch.arange(n, device=q.device)[None, :].expand(b, n)
        valid = all_ids < n_valid[:, None]
        minus_one = torch.full_like(all_ids, -1)
        if not self.cfg.top_straps:
            return torch.where(valid, all_ids, minus_one).to(torch.int32)

        hq = q.shape[1]
        hkv = self.strap_key_sum.shape[2]
        grp = hq // hkv
        qg = q.reshape(b, hkv, grp, -1).float()
        scores = torch.einsum("bhgd,bshd->bs", qg, self.strap_key_sum)
        newest = torch.clamp(n_valid - 1, min=0).long()
        scores = scores + 1e9 * torch.nn.functional.one_hot(
            newest, n).float()                              # keep newest
        scores = torch.where(valid, scores, float("-inf"))
        k = min(self.cfg.top_straps, n)
        ids = torch.topk(scores, k, dim=1).indices
        keep = torch.gather(valid, 1, ids)
        return torch.where(keep, ids, minus_one[:, :k]).to(torch.int32)

    def attend(self, q: torch.Tensor, backend: str = "auto") -> torch.Tensor:
        """Gated decode attention: (B, Hq, hd) -> (B, Hq, hd) in q's dtype.

        Passes `length` so zero-initialised padding slots inside a
        partially filled strap are masked out of the softmax (their raw
        logit is 0, which would otherwise compete with real tokens).
        """
        ids = self.select_straps(q)
        return ops.strap_attend(q, self.k_pages, self.v_pages, ids,
                                self.cfg.pages_per_strap, backend=backend,
                                lengths=self.length)

    def hbm_bytes_per_token(self) -> tuple[int, int]:
        """(gated, dense) bytes read per decode step — the C_BL analogue."""
        b, p, ps, hkv, hd = self.k_pages.shape
        dtype_bytes = self.k_pages.element_size()
        dense = 2 * p * ps * hkv * hd * dtype_bytes
        sel = self.cfg.top_straps or self.n_straps
        gated = 2 * sel * self.cfg.strap_tokens * hkv * hd * dtype_bytes
        return gated, dense
