"""Registry of the 10 architecture configs: a copy of the reference's
``repro/configs/registry.py`` (the same specs, each citing its source), so
an architecture name means the same model in both packages.  Looking a name
up never raises for a family the port cannot build yet; building it does
(``models/model.py::build_model``)."""

from repro_torch.configs.base import ModelConfig

MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    block_pattern=("attn_moe",), num_experts=8, num_experts_per_token=2,
    sliding_window=4096, rope_theta=1e6, mlp_kind="swiglu",
    citation="[arXiv:2401.04088] 8 experts top-2, SWA",
)

LLAMA4_MAVERICK = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    block_pattern=("attn_moe",), num_experts=128, num_experts_per_token=1,
    rope_theta=5e5, mlp_kind="swiglu",
    # early fusion: multimodal prefix embeddings supported via `patches`
    prefix_tokens=0,
    citation="[hf:meta-llama/Llama-4-Scout-17B-16E] MoE 128e top-1, early fusion",
)

GRANITE_20B = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152, mlp_kind="swiglu",
    citation="[arXiv:2405.04324] llama-arch, code, MQA",
)

ZAMBA2_2P7B = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    block_pattern=("mamba2",) * 5 + ("shared_attn",), shared_attn_every=6,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    mlp_kind="gelu",
    citation="[arXiv:2411.15242] Mamba2 + shared attn blocks",
)

GEMMA_7B = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab_size=256000, mlp_kind="geglu",
    norm_offset=True, scale_embeddings=True,
    citation="[arXiv:2403.08295] GeGLU, head_dim=256",
)

LLAMA3_8B = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, mlp_kind="swiglu", rope_theta=5e5,
    citation="[arXiv:2407.21783] GQA, 128k vocab",
)

WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865, mlp_kind="gelu", norm_kind="layernorm",
    positional="sinusoidal", encoder_layers=12, encoder_seq=1500,
    tie_embeddings=True,
    citation="[arXiv:2212.04356] enc-dec, conv frontend stubbed",
)

GRANITE_8B = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152, mlp_kind="swiglu",
    citation="[arXiv:2405.04324] llama-arch, code",
)

MAMBA2_130M = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    block_pattern=("mamba2",), ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=128, positional="none",
    citation="[arXiv:2405.21060] SSD (state-space duality)",
)

PALIGEMMA_3B = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, mlp_kind="geglu",
    norm_offset=True, scale_embeddings=True,
    prefix_tokens=256, prefix_lm=True,
    citation="[arXiv:2407.07726] SigLIP stub + gemma decoder, prefix-LM",
)

ARCHS = {
    c.name: c
    for c in (
        MIXTRAL_8X7B, LLAMA4_MAVERICK, GRANITE_20B, ZAMBA2_2P7B, GEMMA_7B,
        LLAMA3_8B, WHISPER_SMALL, GRANITE_8B, MAMBA2_130M, PALIGEMMA_3B,
    )
}


def get(name: str) -> ModelConfig:
    if name.endswith("-reduced"):
        return ARCHS[name[: -len("-reduced")]].reduced()
    return ARCHS[name]
