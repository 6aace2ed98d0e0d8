"""Analytic per-device HBM traffic and model FLOPs (port of
`repro.roofline.analytic`: the same arithmetic, term by term).

The model is the reference's own GSPMD schedule, not the port's: tensor
parallelism TP = 16 over "model" and FSDP over "data", the batch over
the dp axes (`distributed/sharding.py`'s rules), the weights gathered a
TP shard at a time.  It counts what must cross HBM on one device a step:

train (per device):
    weights      3 x P_bytes / TP          (fwd + remat re-fwd + bwd reads
                                            of the gathered TP shard)
    grads        P_bytes / n_dev           (reduce-scattered shard write)
    optimizer    20 B/param / n_dev        (m,v read+write fp32, p r+w bf16;
                                            8 for AdamW8bit)
    activations  4 x L x tok_dev x d x 2   (layer inputs w+r, fwd+bwd;
                                            nothing-saveable remat)
    logits       2 x tok_dev x V/TP x 4    (f32 write+read for CE)
prefill:
    weights 1x, activations 2x (no bwd), cache write, logits last token
decode:
    weights 1x (MoE: only the touched expert fraction) + full cache read
    + one-token cache write

The port's sharded step is data-parallel on every axis: it gathers every
parameter whole on each rank and the "model" ranks repeat the dense
compute (`train.step.make_sharded_train_step`).  It therefore moves more
bytes than this model gives (the whole weights, not a 1/TP shard, three
times a step); the FLOPs, collective bytes and peak memory that
`roofline.counts` records around the port's own step measure the
difference.  A mesh of fewer than 16 devices takes TP = n_dev.
"""

from __future__ import annotations

import numpy as np

from ..configs.base import SHAPE_CELLS
from ..models import registry as M

TP = 16


def _cache_bytes(cfg, b: int, s: int) -> int:
    sch = M.cache_schema(cfg, b, s)
    total = 0
    for k, spec in sch.items():
        itemsize = 4 if "ssm" in k else 2
        total += int(np.prod(spec.shape)) * itemsize
    return total


def hbm_bytes_per_device(cfg, cell: str, n_dev: int = 256) -> float:
    spec = SHAPE_CELLS[cell]
    return hbm_bytes(cfg, spec["kind"], spec["global_batch"],
                     spec["seq_len"], n_dev)


def hbm_bytes(cfg, kind: str, b: int, s: int, n_dev: int) -> float:
    """`hbm_bytes_per_device` of a global batch b x s of `kind` ("train",
    "prefill" or "decode") over n_dev devices."""
    tp = min(TP, n_dev)
    dp = n_dev // tp
    n = cfg.param_count()
    p_bytes = 2 * n
    tok_dev = b * s / min(dp, b) if b >= 1 else b * s
    d = cfg.d_model
    L = cfg.n_layers + cfg.n_enc_layers
    v_shard = cfg.padded_vocab / tp

    if kind == "train":
        weights = 3 * p_bytes / tp
        grads = p_bytes / n_dev
        opt = (20 if cfg.optimizer == "adamw" else 8) * n / n_dev
        acts = 4 * L * tok_dev * d * 2
        logits = 2 * tok_dev * v_shard * 4
        return weights + grads + opt + acts + logits

    if kind == "prefill":
        weights = p_bytes / tp
        acts = 2 * L * tok_dev * d * 2
        cache = _cache_bytes(cfg, b, s) / n_dev
        logits = 2 * (b / min(dp, max(b, 1))) * v_shard * 4
        return weights + acts + cache + logits

    # decode: few tokens -> weights-stationary schedule (weights stay
    # sharded across ALL devices; activations travel + psum instead of
    # gathering weights), so each device reads only its own shard.
    if cfg.n_experts:
        frac = min(1.0, b * cfg.top_k / cfg.n_experts)
        expert_bytes = 2 * cfg.n_layers * cfg.n_experts * 3 * d * cfg.d_ff
        non_expert = p_bytes - expert_bytes
        weights = (non_expert + frac * expert_bytes) / n_dev
    else:
        weights = p_bytes / n_dev
    cache = _cache_bytes(cfg, b, s) / n_dev      # sharded across all devices
    if cfg.strap_decode and cfg.family in ("dense", "moe", "vlm"):
        # selector+strap: only the selected straps are read from HBM;
        # the dense baseline's one-hot update also rewrote the full cache
        # (r+w) which the scatter update avoids.
        nst = max(s // cfg.decode_strap_tokens, 1)
        frac = min(cfg.decode_top_straps, nst) / nst
        read = cache * frac + cache / max(s, 1) * 64   # + ksum metadata
        write = cache / max(s, 1)
        return weights + read + write
    # baseline dense decode: attention read + one-hot full-cache rewrite
    write = cache / max(s, 1)
    return weights + 3 * cache + write


def model_flops(cfg, cell: str) -> float:
    """Mandated MODEL_FLOPS: 6*N*D train (N_active for MoE); 2*N*D prefill;
    2*N*B decode."""
    spec = SHAPE_CELLS[cell]
    b, s, kind = spec["global_batch"], spec["seq_len"], spec["kind"]
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * b * s
    if kind == "prefill":
        return 2.0 * n * b * s
    return 2.0 * n * b
