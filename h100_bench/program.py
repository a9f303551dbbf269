"""The system under test: the port's objects built from the run's inputs.

Everything the benchmark times goes through ``convdr_torch``'s own entry
points: ``OnlineSearcher.search_tokens`` (built through its public
constructor, its search closure the flat f32 branch of
``OnlineSearcher.from_blocks``), the step ``make_train_step`` returns and
its optimizer. Only this module and the drivers import ``convdr_torch``;
the reference never does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from convdr_torch.core.registry import get_model_config
from convdr_torch.models.encoders import build_model as port_build_model
from convdr_torch.models.transformer import cast_at_use, to_compute_dtype

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(cfg: dict):
    """The port's ``ModelConfig`` at the configuration's widths."""
    mc = get_model_config(cfg["model_type"])
    arch = dataclasses.replace(
        mc.arch,
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"],
        pad_token_id=cfg["pad_token_id"],
        position_offset=cfg["pad_token_id"] + 1 if cfg["position_ids"] == "roberta" else 0,
        hidden_dropout=cfg["hidden_dropout_prob"],
        attention_dropout=cfg["attention_probs_dropout_prob"],
        gelu_approximate=cfg["hidden_act"] != "gelu",
    )
    return dataclasses.replace(mc, arch=arch, embedding_dim=cfg["embedding_dim"])


def build_model(cfg: dict, weights: Dict[str, torch.Tensor], device, *,
                master_weights: bool = False) -> torch.nn.Module:
    """The port's model on ``device`` holding a copy of ``weights``,
    computing in the configuration's dtype: parameters cast to it (serving,
    the frozen teacher) or kept f32 and cast where used (a student)."""
    with torch.device("meta"):
        model = port_build_model(model_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    dtype = DTYPES[cfg["compute_dtype"]]
    model = (cast_at_use if master_weights else to_compute_dtype)(model, dtype)
    return model.eval()


class Specials:
    """The tokenizer field a token-fed ``OnlineSearcher`` reads: the id its
    capture puts first in a row."""

    def __init__(self, layout: dict):
        self.cls_token_id = layout["cls_id"]


def searcher(cfg: dict, model: torch.nn.Module, corpus: torch.Tensor, device):
    """``OnlineSearcher`` over the resident ``corpus`` ([padded rows, D]
    f32), searched as ``OnlineSearcher.from_blocks`` searches float rows."""
    from convdr_torch.ops.exact_search import flat_ip_topk
    from convdr_torch.retrieval.online import OnlineSearcher

    n, top_n = cfg["corpus_rows"], cfg["top_k"]
    block_rows = max(1, min(cfg["block_rows"], corpus.shape[0]))
    precision = cfg["matmul_precision"]

    @torch.inference_mode()
    def search_embeddings(q):
        return flat_ip_topk(q, corpus, top_n, block_rows=block_rows, valid_rows=n,
                            precision=precision)

    return OnlineSearcher(
        tokenizer=Specials(cfg["layout"]), model=model, search_embeddings=search_embeddings,
        operands=(corpus,), top_n=top_n, model_type=cfg["model_type"],
        max_concat_length=cfg["max_concat_length"], device=device, rowid_to_offset=None,
    )


def row_tile() -> int:
    """Rows the score kernel's corpus is padded to."""
    from convdr_torch.ops.fused_search import ROW_TILE

    return ROW_TILE


def build_kernels() -> None:
    """Build every CUDA source of the port at once (one nvcc each, in
    parallel), so a first run compiles before anything is timed."""
    import os

    from convdr_torch.ops import cuda_build

    names = sorted(n[:-3] for n in os.listdir(cuda_build.CSRC_DIR) if n.endswith(".cu"))
    cuda_build.build(names)


def train_step(cfg: dict, mix: dict, weights: Dict[str, torch.Tensor], device):
    """(state, step, teacher) of the port's KD + ranking trainer: the
    student and the frozen teacher both hold a copy of ``weights``."""
    from convdr_torch.core.config import TrainConfig
    from convdr_torch.train.trainer import create_train_state, make_train_step

    tc = TrainConfig(
        learning_rate=mix["learning_rate"], weight_decay=mix["weight_decay"],
        adam_epsilon=mix["adam_epsilon"], max_grad_norm=mix["max_grad_norm"],
        warmup_steps=mix["warmup_steps"], per_device_batch_size=mix["batch_size"],
        num_negatives=mix["num_negatives"], ranking_task=True,
        max_concat_length=mix["max_concat_length"], max_query_length=mix["max_query_length"],
        max_doc_length=mix["max_doc_length"], use_dropout=False, doc_length_buckets=None,
    )
    student = build_model(cfg, weights, device, master_weights=True)
    teacher = build_model(cfg, weights, device)
    teacher.requires_grad_(False)  # as run_convdr_train freezes it
    state, tx = create_train_state(student, tc, mix["total_steps"])
    return state, make_train_step(student, teacher, tx, tc), teacher
