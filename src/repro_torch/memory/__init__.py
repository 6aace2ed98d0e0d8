"""Paged KV-cache storage: the selector+strap cache (StrapKVCache)."""
