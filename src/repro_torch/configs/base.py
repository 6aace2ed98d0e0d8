"""Architecture config schema, shape cells and abstract input specs (port
of `repro.configs.base`).

Every architecture is a frozen `ArchConfig`.  `input_specs(cfg, cell)`
gives every model input of a shape cell as a tensor on the `meta` device
(shape and dtype, no storage): PyTorch's counterpart of the reference's
`jax.ShapeDtypeStruct`, so no memory is allocated for the full-size
configs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# ---------------------------------------------------------------------------
# Shape cells (assigned): seq_len x global_batch
# ---------------------------------------------------------------------------

SHAPE_CELLS = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}

SMOKE_SHAPE = dict(seq_len=128, global_batch=2, kind="train")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln (olmo)
    act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 2
    moe_dense_residual: bool = False    # arctic: dense MLP in parallel
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    conv_kernel: int = 4
    # --- hybrid (zamba2): one shared attn+mlp block every N ssm layers ---
    shared_attn_every: int = 0
    # --- enc-dec (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    # --- vlm (pixtral): stub ViT embeddings prepended to the text stream ---
    n_vision_tokens: int = 0
    # --- numerics / execution ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 512         # query-block size for chunked attention
    optimizer: str = "adamw"      # adamw | adamw8bit (int8 moments)
    remat: bool = True
    # selector+strap gated decode (the paper's technique in the HLO):
    strap_decode: bool = False
    decode_strap_tokens: int = 2048
    decode_top_straps: int = 8
    # perf levers of the reference's sharded runs (kept as fields):
    shard_acts: bool = False      # explicit activation sharding constraints
    seq_parallel: bool = False    # Megatron-style: residual stream seq-sharded
    ssm_split_proj: bool = False  # shard-aligned per-stream SSM projections
    moe_ep: bool = False          # shard_map expert-parallel MoE dispatch
    vocab_round: int = 256        # pad vocab to multiple (16-way TP of embed)
    # --- provenance ---
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, self.vocab_round)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k decode? (SSM / hybrid only)."""
        return self.family in ("ssm", "hybrid")

    def runnable_cells(self) -> list[str]:
        cells = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            cells.append("long_500k")
        return cells

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        mlp = 3 * d * f if self.act == "swiglu" else 2 * d * f
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per_layer = self._ssm_layer_params()
            return self.n_layers * per_layer + emb + d
        if self.family == "hybrid":
            per_ssm = self._ssm_layer_params()
            shared = attn + mlp + 2 * d
            return self.n_layers * per_ssm + shared + emb + d
        if self.n_experts:
            expert_mlp = self.n_experts * 3 * d * f + d * self.n_experts
            dense_res = 3 * d * f if self.moe_dense_residual else 0
            return self.n_layers * (attn + expert_mlp + dense_res + 2 * d) + emb + d
        layers = self.n_layers * (attn + mlp + 2 * d)
        if self.is_encdec:
            layers += self.n_enc_layers * (attn + mlp + 2 * d)
            layers += self.n_layers * (attn + d)       # cross-attention
        return layers + emb + d

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts top_k experts only."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) * 3 * d * f
        return total - inactive

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration: same family/topology, tiny sizes."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            vocab_round=64,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            capacity_factor=4.0,      # no capacity drops at smoke scale
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_vision_tokens=8 if self.n_vision_tokens else 0,
            attn_chunk=32,
            param_dtype="float32",
            compute_dtype="float32",
        )

    def _ssm_layer_params(self) -> int:
        d, di = self.d_model, self.d_inner
        ng, st = self.ssm_ngroups, self.ssm_state
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * ng * st + nh)
        conv = self.conv_kernel * (di + 2 * ng * st)
        out_proj = di * d
        return in_proj + conv + out_proj + 2 * nh + di + d


# ---------------------------------------------------------------------------
# Abstract input specs per shape cell
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    if min(shape) < 0:
        # the reference returns a ShapeDtypeStruct with the negative dim
        # (a VLM whose vision tokens outnumber the cell's sequence); a
        # tensor cannot have one
        raise ValueError(f"input spec of shape {shape}: the cell's sequence "
                         "is shorter than the config's vision tokens")
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, cell: str) -> dict:
    """Meta-tensor stand-ins (shape and dtype) for every model input of
    the cell; a name outside `SHAPE_CELLS` takes `SMOKE_SHAPE`.

    Modality frontends are stubs: audio (whisper) supplies precomputed frame
    embeddings; vlm (pixtral) supplies precomputed patch embeddings.
    """
    spec = SHAPE_CELLS[cell] if cell in SHAPE_CELLS else SMOKE_SHAPE
    return shape_inputs(cfg, spec["kind"], spec["global_batch"],
                        spec["seq_len"])


def shape_inputs(cfg: ArchConfig, kind: str, b: int, s: int) -> dict:
    """`input_specs` of a global batch b x s of `kind` ("train",
    "prefill" or "decode")."""
    emb_dt = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
              else torch.float32)

    if cfg.is_encdec:
        # encoder frames : decoder tokens split the cell's seq budget
        s_enc, s_dec = s // 2, s // 2
        if kind == "train":
            return dict(enc_embeds=_sds((b, s_enc, cfg.d_model), emb_dt),
                        tokens=_sds((b, s_dec), torch.int32),
                        targets=_sds((b, s_dec), torch.int32))
        if kind == "prefill":
            return dict(enc_embeds=_sds((b, s_enc, cfg.d_model), emb_dt),
                        tokens=_sds((b, s_dec), torch.int32))
        return dict(token=_sds((b, 1), torch.int32),
                    pos=_sds((b,), torch.int32))

    if cfg.n_vision_tokens and kind != "decode":
        nv = cfg.n_vision_tokens
        if kind == "train":
            return dict(vision_embeds=_sds((b, nv, cfg.d_model), emb_dt),
                        tokens=_sds((b, s - nv), torch.int32),
                        targets=_sds((b, s - nv), torch.int32))
        return dict(vision_embeds=_sds((b, nv, cfg.d_model), emb_dt),
                    tokens=_sds((b, s - nv), torch.int32))

    if kind == "train":
        return dict(tokens=_sds((b, s), torch.int32),
                    targets=_sds((b, s), torch.int32))
    if kind == "prefill":
        return dict(tokens=_sds((b, s), torch.int32))
    # decode: one new token against a cache of length s (the cache's
    # shapes come from the model's cache_schema()).
    return dict(token=_sds((b, 1), torch.int32), pos=_sds((b,), torch.int32))


def cell_batch_seq(cell: str) -> tuple[int, int]:
    spec = SHAPE_CELLS[cell]
    return spec["global_batch"], spec["seq_len"]
