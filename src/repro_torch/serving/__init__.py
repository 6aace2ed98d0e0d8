"""Batched LM serving: the engine with dense and strap-cache back-ends."""
