"""Model definitions of the port (dense decoder family): schema-driven
parameter trees, norms, RoPE, attention, MLP and the LM's prefill and
decode step."""
