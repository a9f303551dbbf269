"""Model registry.

Counterpart of the reference's ``MSMarcoConfigDict``
(reference model/models.py:275-311): maps the ``--model_type`` CLI
string to a :class:`~convdr_torch.core.config.ModelConfig`. The three reference
entries are preserved:

  * ``rdot_nll``             -- ANCE RoBERTa dot-product encoder
  * ``rdot_nll_multi_chunk`` -- same, with FirstP multi-chunk long documents
  * ``dpr``                  -- BERT bi-encoder (two towers)
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from convdr_torch.core.config import EncoderArchConfig, ModelConfig


def _build_registry() -> Dict[str, ModelConfig]:
    roberta = EncoderArchConfig.roberta_base()
    bert = EncoderArchConfig.bert_base()
    return {
        "rdot_nll": ModelConfig(
            name="rdot_nll",
            arch=roberta,
            projection_head=True,
            two_tower=False,
            multi_chunk=False,
            tokenizer_kind="roberta",
        ),
        "rdot_nll_multi_chunk": ModelConfig(
            name="rdot_nll_multi_chunk",
            arch=roberta,
            projection_head=True,
            two_tower=False,
            multi_chunk=True,
            chunk_len=512,
            tokenizer_kind="roberta",
        ),
        "dpr": ModelConfig(
            name="dpr",
            arch=bert,
            projection_head=False,
            two_tower=True,
            multi_chunk=False,
            tokenizer_kind="bert",
        ),
    }


MODEL_REGISTRY: Dict[str, ModelConfig] = _build_registry()


def get_model_config(model_type: str, **overrides) -> ModelConfig:
    """Look up a model config by registry name, with optional field overrides."""
    key = model_type.lower()
    if key not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model_type {model_type!r}; choices: {sorted(MODEL_REGISTRY)}"
        )
    cfg = MODEL_REGISTRY[key]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
