"""Run and architecture configuration: copies of the reference's
``FLConfig``, ``ModelConfig`` and ``InputShape`` (``repro/configs/base.py``)
with the same fields, defaults, validation and methods, so one scenario or
one architecture name means the same run in both packages.

``ModelConfig`` is data: all of its fields are kept, also those of the
encoder-decoder family, which the port cannot build yet
(``models/model.py::build_model`` raises for it), and ``moe_ep_axis``, a
sharding hint that the port's one-device MoE ignores.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # per-layer block kinds, cycled over num_layers.
    # kinds: 'attn_mlp' | 'attn_moe' | 'mamba2' | 'shared_attn'
    block_pattern: tuple = ("attn_mlp",)

    # attention
    rope_theta: float = 10000.0
    sliding_window: int | None = None     # SWA window (mixtral: 4096)
    positional: str = "rope"              # rope | learned | sinusoidal | none

    # mlp
    mlp_kind: str = "swiglu"              # swiglu | geglu | gelu
    norm_kind: str = "rmsnorm"            # rmsnorm | layernorm
    norm_offset: bool = False             # gemma-style (1 + w) scaling
    scale_embeddings: bool = False        # gemma: emb * sqrt(d)
    tie_embeddings: bool = True

    # moe
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 1024            # GShard-style dispatch group
    router_aux_coef: float = 0.01
    # expert-parallel axis (§Perf): when set (e.g. 'data'), apply_moe adds
    # with_sharding_constraint so expert compute is sharded over this mesh
    # axis (token all-to-all) instead of FSDP weight all-gathers.  Requires
    # an active mesh context; None = portable baseline.
    moe_ep_axis: str | None = None

    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (zamba2): how often the shared attention block fires
    shared_attn_every: int = 0

    # encoder-decoder (whisper): encoder consumes stub frame embeddings
    encoder_layers: int = 0
    encoder_seq: int = 0                  # e.g. 1500 mel frames (stubbed)

    # vlm (paligemma): stub patch embeddings prepended as a prefix
    prefix_tokens: int = 0
    prefix_lm: bool = False

    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def attention_free(self) -> bool:
        return all(k == "mamba2" for k in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True iff decode state is o(seq): SSM/hybrid-with-window or SWA."""
        kinds = set(self.layer_kinds())
        if kinds <= {"mamba2"}:
            return True
        if self.sliding_window is not None:
            return True
        return False

    def layer_kinds(self) -> tuple:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        if self.mlp_kind in ("swiglu", "geglu"):
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        moe = self.num_experts * mlp + d * self.num_experts
        d_in = self.ssm_expand * d
        nheads_ssm = max(1, d_in // max(1, self.ssm_head_dim))
        conv_dim = d_in + 2 * self.ssm_state
        mamba = (
            d * (2 * d_in + 2 * self.ssm_state + nheads_ssm)   # in_proj
            + conv_dim * self.ssm_conv                          # conv
            + 3 * nheads_ssm                                    # A, D, dt_bias
            + d_in                                              # gated norm
            + d_in * d                                          # out_proj
        )
        total = 0
        shared_attn_counted = False
        for kind in self.layer_kinds():
            if kind == "attn_mlp":
                total += qkv + mlp + 2 * d
            elif kind == "attn_moe":
                total += qkv + moe + 2 * d
            elif kind == "mamba2":
                total += mamba + d
            elif kind == "shared_attn":
                if not shared_attn_counted:
                    total += qkv + mlp + 2 * d
                    shared_attn_counted = True
        total += self.vocab_size * d                         # embeddings
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += self.encoder_layers * (qkv + mlp + 2 * d)   # whisper encoder
        if self.encoder_layers:                               # cross-attn in dec
            total += self.num_layers * (qkv + 2 * d)
        total += d                                            # final norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only) for 6ND."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        mlp = (3 if self.mlp_kind in ("swiglu", "geglu") else 2) * d * self.d_ff
        inactive = 0
        for kind in self.layer_kinds():
            if kind == "attn_moe":
                inactive += (self.num_experts - self.num_experts_per_token) * mlp
        return self.param_count() - inactive

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: same family/topology, tiny dims."""
        pat = self.block_pattern
        n_layers = max(2, len(pat))
        if self.shared_attn_every:
            n_layers = self.shared_attn_every  # one full hybrid cycle
        d = min(self.d_model, 128)
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        return self.with_(
            name=self.name + "-reduced",
            num_layers=n_layers,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=min(self.resolved_head_dim, 32) if self.head_dim else 0,
            d_ff=min(self.d_ff, 256),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_token=min(self.num_experts_per_token, 2)
            if self.num_experts_per_token
            else 0,
            moe_group_size=64,
            # dropless capacity so reduced-model equivalence tests are exact
            moe_capacity_factor=float(max(self.num_experts, 1)),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16,
            sliding_window=64 if self.sliding_window else None,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64) if self.encoder_seq else 0,
            prefix_tokens=min(self.prefix_tokens, 16) if self.prefix_tokens else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # 'train' | 'prefill' | 'decode'


@dataclass(frozen=True)
class FLConfig:
    """Federated-round configuration (the paper's knobs)."""
    n_clients: int = 32            # n
    expected_clients: int = 6      # m
    # sampler zoo (core/sampling.py::SAMPLERS):
    # optimal | aocs | uniform | full | clustered | cyclic | threshold
    sampler: str = "aocs"
    j_max: int = 4                 # AOCS iterations
    local_steps: int = 1           # R (R=1 ~ DSGD on the local batch)
    algorithm: str = "fedavg"      # fedavg | dsgd
    lr_local: float = 0.125        # eta_l (paper: 2^-3 for OCS/full)
    lr_global: float = 1.0         # eta_g (paper: 1.0)
    weights: str = "uniform"       # w_i scheme: uniform | data_size
    # beyond-paper (paper Sec. 6 future work): compress transmitted updates
    compression: str = "none"      # none | randk | qsgd | natural
    compression_param: float = 0.1 # randk fraction / qsgd levels (natural: unused)
    # paper Appendix E: per-client availability probability q (1.0 = always)
    availability: float = 1.0
    # system-realism over-selection (sim/pool.py client-state layer): sample
    # round(m * over_select) clients so the post-deadline/dropout survivor
    # count still approaches m.  1.0 = the paper's plain m-target plan.
    over_select: float = 1.0
    # round-engine execution policy (fl/engine.py) — orthogonal axes:
    round_engine: str = "vmap"     # memory policy: vmap | scan (single-pass OCS)
    agg_backend: str = "jnp"       # masked-aggregate backend: jnp | pallas
    scan_group: int = 2            # clients per scan group (round_engine='scan')
    # bounded HBM update cache of the scan engine (kernels/update_cache.py):
    # pass 1 parks the first cache_groups groups' update matrices
    # (cache_groups * scan_group * d elements); post-plan those aggregate
    # without recomputing local_update, groups beyond capacity spill to
    # recompute.  0 = no cache (the original two-pass scan, 2n evals/round);
    # >= n_clients/scan_group = every update computed exactly once.
    cache_groups: int = 8
    # mesh execution (fl/shard_round.py, selected by fl.engine.make_engine
    # when a mesh is active): the mesh axis the client dimension shards over.
    # agg_backend applies on this path too — 'pallas' runs the per-shard
    # fused kernel (kernels/sharded_aggregate.py) + one cross-shard psum.
    client_axis: str = "data"

    def __post_init__(self):
        if self.cache_groups < 0:
            raise ValueError(
                f"cache_groups must be >= 0 (0 disables the update cache), "
                f"got {self.cache_groups}"
            )
        if self.scan_group < 1:
            raise ValueError(f"scan_group must be >= 1, got {self.scan_group}")
        if not 1.0 <= self.over_select <= float(max(self.n_clients, 1)):
            raise ValueError(
                f"over_select must be in [1, n_clients], got {self.over_select}"
            )

    def cohort_target(self) -> int:
        """The sampling plan's m after over-selection: ``round(m * over_select)``
        clamped to ``[1, n_clients]`` (== ``expected_clients`` when
        ``over_select`` is 1, preserving the paper's plan bit-for-bit)."""
        m = int(round(self.expected_clients * self.over_select))
        return max(1, min(m, self.n_clients))
