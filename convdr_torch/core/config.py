"""Typed configuration for the framework.

Replaces the reference's per-driver argparse namespaces with frozen
dataclasses. Driver CLIs construct these from flag values, keeping the
reference's flag surface (--model_type, --query, --max_concat_length, ...)
intact. Field for field the same as the JAX package's configuration, so one
set of flags means the same model and search in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class EncoderArchConfig:
    """Transformer encoder architecture (BERT/RoBERTa base by default)."""

    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    # RoBERTa offsets position ids by pad_token_id + 1; BERT starts at 0.
    position_offset: int = 2
    pad_token_id: int = 1
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # GELU flavor: False = exact erf (HF-parity numerics), True = tanh
    # approximation (inside the bf16 noise floor under bf16 compute).
    gelu_approximate: bool = False

    @staticmethod
    def roberta_base(vocab_size: int = 50265) -> "EncoderArchConfig":
        return EncoderArchConfig(vocab_size=vocab_size)

    @staticmethod
    def bert_base(vocab_size: int = 30522) -> "EncoderArchConfig":
        return EncoderArchConfig(
            vocab_size=vocab_size,
            max_position_embeddings=512,
            type_vocab_size=2,
            layer_norm_eps=1e-12,
            position_offset=0,
            pad_token_id=0,
        )

    @staticmethod
    def tiny(vocab_size: int = 256, roberta: bool = True) -> "EncoderArchConfig":
        """A miniature config for tests; same topology, tiny dims."""
        base = (
            EncoderArchConfig.roberta_base(vocab_size)
            if roberta
            else EncoderArchConfig.bert_base(vocab_size)
        )
        return dataclasses.replace(
            base,
            hidden_size=32,
            num_layers=2,
            num_heads=2,
            intermediate_size=64,
            max_position_embeddings=key_len(base, 130),
        )


def key_len(base: EncoderArchConfig, n: int) -> int:
    return n + base.position_offset


@dataclasses.dataclass(frozen=True)
class DecoderArchConfig:
    """A DeepSeek-V2 decoder stack (defaults: DeepSeek-V2-Lite's published
    ``config.json``): multi-head latent attention with no q-LoRA, YaRN
    rotary positions, a leading dense SwiGLU layer and then layers of a
    softmax router over routed experts beside always-on shared experts.
    Used as a RepLLaMA-style encoder (causal mask, last-token pooling)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # rope_scaling {"type": "yarn", ...}
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @staticmethod
    def tiny(vocab_size: int = 256) -> "DecoderArchConfig":
        """A miniature config for tests: hidden 64, one dense and three
        expert layers of 8 experts, top-2, one shared expert."""
        return DecoderArchConfig(
            vocab_size=vocab_size, hidden_size=64, num_layers=4, num_heads=2,
            kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            intermediate_size=96, moe_intermediate_size=32, n_routed_experts=8,
            n_shared_experts=1, num_experts_per_tok=2,
        )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A retrieval model = encoder arch + head + pooling choices.

    Mirrors the reference registry entries (model/models.py:291-309):
    rdot_nll / rdot_nll_multi_chunk (RoBERTa + 768-d head + LN, first-token
    pool) and dpr (two BERT towers, CLS pool, no head).
    """

    name: str
    arch: Union[EncoderArchConfig, DecoderArchConfig]
    embedding_dim: int = 768
    use_mean: bool = False
    # ANCE-style projection head + LayerNorm (models.py:136-137); DPR has none.
    projection_head: bool = True
    # Two independent towers (DPR) vs a single shared encoder (ANCE).
    two_tower: bool = False
    # Multi-chunk FirstP long-document handling (models.py:159-188).
    multi_chunk: bool = False
    chunk_len: int = 512
    # "roberta" (byte BPE) | "bert" (WordPiece) | "deepseek" (its files are
    # not in the repository: the decoder is fed token ids)
    tokenizer_kind: str = "roberta"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """KD + ranking training hyperparameters.

    Defaults track the reference's run_convdr_train.py:255-435 and
    README.md:160-164 (bs 4/device, lr 1e-5, clip 1.0, 9 negatives).
    """

    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_steps: int = 0
    num_train_epochs: float = 1.0
    max_steps: int = -1
    per_device_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    num_negatives: int = 9
    ranking_task: bool = False
    no_mse: bool = False
    max_concat_length: int = 256
    max_query_length: int = 64
    max_doc_length: int = 512
    seed: int = 42
    log_steps: int = 1
    save_steps: int = -1
    # Reference parity: torch model.train() keeps dropout active during KD
    # (run_convdr_train.py:107); off by default (deterministic KD). On, the
    # student's dropout draws from a generator seeded by (seed, step).
    use_dropout: bool = False
    # Ranking-doc length rungs: each batch's doc tensor is trimmed to the
    # smallest rung covering its longest document. Teacher doc embeddings
    # are unchanged -- pads never reach valid tokens -- but short-doc
    # corpora skip most of the doc-encode work, the dominant cost of a
    # ranking step. None = fixed max_doc_length (reference behavior).
    doc_length_buckets: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Exact inner-product retrieval configuration.

    Passage blocks mirror the reference's sequential block design
    (README.md:216).
    """

    # Passages per scan block: the [Q, block] f32 score buffer of one scan
    # step is Q * passage_block_size * 4 bytes (1 GiB at Q=512).
    passage_block_size: int = 524288
    # Embedding storage on the device: "float32" (FAISS-bit exact),
    # "bfloat16" (half the device memory; a cast on upload, scores still
    # accumulate in f32) or "int8" (SQ8 scalar quantization, ops/quant.py:
    # a quarter of the device memory, bit-exact vs the int8 oracle).
    storage_dtype: str = "float32"
    # "highest" = oracle-bit-exact (full f32, no TF32); "high" / "default"
    # trade score error for matmul speed on the card (a TF32 / a bf16
    # product, ops/exact_search.py::rounded_scores; full f32 on the CPU).
    # Ignored for int8 storage, whose scores are exact integers.
    matmul_precision: str = "highest"
    # int8/bf16 storage only: re-rank the top (rescore_factor * top_n)
    # quantized candidates of each block with full-precision host-side
    # inner products before the final cut (FAISS IndexRefineFlat's
    # k_factor). Needs the original float rows (float block files). 0 = off.
    rescore_factor: int = 0
    # Device-side capacity cap: an on-disk block whose embedding matrix
    # exceeds this many bytes is searched as sequential sub-blocks (results
    # merged in order, preserving the lower-index tie preference).
    max_device_block_bytes: int = 3_200_000_000


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Tokenization limits (reference data/tokenizing.py flags)."""

    max_seq_length: int = 512
    max_query_length: int = 64
    max_doc_character: int = 10000
    num_tokenize_workers: int = 32


NUM_FOLD = 5  # 5-fold CV harness (utils/util.py:32)
