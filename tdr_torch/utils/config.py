# Copied from tdr/utils/config.py (imports rewritten), plus the port's own
# MlaMoeConfig.
"""Single-dataclass configuration for the whole framework.

The reference has no config system — constants are scattered at module tops
(paths: cosine_similarity_bm25_reranking.py:17-22; BM25 k1=1.5 b=0.75 defaults
e.g. bm25_ranking.ipynb:166; batch sizes 400/100/32; MAX_CANDIDATES=1000
team_run1.py:164; SVD dims 256 faiss_based_ANN_Implementation.py:269).  Here
they are collected into typed dataclasses (SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Sequence

LANGS = ("ar", "de", "en", "es", "fr", "it", "ko")


@dataclass(frozen=True)
class DataConfig:
    """L0 ingest paths and split policy (bm25_ranking.ipynb:260 semantics)."""

    corpus_path: str = "data/corpus.json"
    train_path: str = "data/train.csv"
    dev_path: str = "data/dev.csv"
    test_path: str = "data/test.csv"
    val_fraction: float = 0.1     # 90/10 split of train
    split_seed: int = 42          # fixed seed, matches the reference
    langs: Sequence[str] = LANGS


@dataclass(frozen=True)
class BM25Config:
    """Okapi BM25 parameters.

    ``dl_scaled_by_b=False`` pins the *reference's* winning variant, whose
    denominator is ``tf + k1*(1 - b + dl/avgdl)`` — the dl/avgdl term is NOT
    multiplied by b (bm25_ranking.ipynb:202, final_implementation.py:142).
    Set True for the textbook formula used by the v2 pipelines
    (team_run1.py:193, cosine_similarity_bm25_reranking.py:193).
    """

    k1: float = 1.5
    b: float = 0.75
    dl_scaled_by_b: bool = False
    # IDF variant: "bm25" = ln(1+(N-df+.5)/(df+.5))  (bm25_ranking.ipynb:188-190)
    #             "bm25_plus1" = ln((N-df+.5)/(df+.5)+1)  (same value, team_run1.py:187)
    #             "classic" = ln((N+1)/(df+1))+1  (faiss_based_ANN_Implementation.py:88)
    idf_variant: str = "bm25"


@dataclass(frozen=True)
class IndexConfig:
    """L2 index build: padded-CSR layout + vocab policy."""

    min_df: int = 1               # df pruning threshold (ranking_with_bm25.py:29)
    max_doc_tokens: int = 0       # 0 = no truncation when tokenizing docs
    # Head/tail split for the TPU scoring kernel: terms with df >= head_min_df
    # get dense bf16 score rows (MXU/VPU path); the long-tail stays CSR.
    head_min_df: int = 0          # 0 = auto from head_budget_bytes
    head_budget_bytes: int = 1 << 31   # dense-head budget.  Semantics
    # depend on the builder: build_language_models treats it as the
    # TOTAL across languages (waterfilled, capped at full-vocab
    # coverage each); direct builders (BM25Model.build, sharded) use it
    # per index — hence a conservative 2 GiB default.  Registry builds
    # at reference scale pass ~4 GiB so en saturates (CLI --head-budget-gb,
    # bench TDR_HEAD_BUDGET).
    # dense head rows dtype: "bfloat16" halves HBM traffic of the dominant
    # head-row gathers (CSR weights stay float32); use "float32" when
    # bitwise score parity with the f64 formulas matters more than speed.
    # "int8" scalar-quantizes the head per document column (the FAISS SQ8
    # analogue): halves HBM traffic AGAIN vs bf16 and doubles MXU rate
    # (int8 systolic path) at ~0.4% per-entry score rounding — the tail and
    # the top-2k merge stay exact (see tdr.ops.score._head_scores_matmul).
    head_dtype: str = "bfloat16"
    doc_pad_multiple: int = 128   # pad doc axis to lane multiples
    nnz_pad_multiple: int = 1024  # pad CSR nnz to static shapes
    # quantize static dims (vocab, nnz, doc pad, head, tail) onto a coarse
    # geometric grid so different corpora/languages share compiled kernels
    # (each unique shape costs a full XLA compile; with remote compilation
    # that is 30-190s per shape).  Waste bound: <= ~33% padding per dim.
    shape_bucketing: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for sharded indexing/scoring and dense-model training.

    Axes: ``data`` shards the document/corpus axis (SURVEY.md §2c "data
    parallelism — corpus axis"), ``model`` shards dense-model tensors (TP).
    """

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 0        # 0 = use all devices on the data axis
    model_parallel: int = 1


@dataclass(frozen=True)
class RetrievalConfig:
    """L4 orchestration: batching, candidate caps, cascade sizes."""

    top_k: int = 10
    query_batch: int = 128        # reference used 400/200/100/64/32 by path
    max_query_terms: int = 64     # static pad of unique query terms
    candidates: int = 200         # cosine→BM25 cascade width (cosine_similarity_bm25_reranking.py:229)
    max_candidates: int = 1000    # boolean-union cap (team_run1.py:164)


@dataclass(frozen=True)
class DenseConfig:
    """Dense multilingual encoder + ANN path (replaces FAISS, SURVEY.md §2b)."""

    vocab_size: int = 50_000      # hashed subword vocab
    dim: int = 384                # MiniLM-class width
    depth: int = 6
    heads: int = 12
    mlp_ratio: float = 4.0
    max_len: int = 128
    dtype: str = "bfloat16"
    svd_dim: int = 256            # TruncatedSVD dims in the reference ANN path
    ivf_nlist: int = 64           # IVF partitions for the ANN index
    ivf_nprobe: int = 8


@dataclass(frozen=True)
class MlaMoeConfig:
    """DeepSeek-V2's block as a dense retrieval encoder
    (``tdr_torch.models.mla_moe``): multi-head latent attention with YaRN
    rotary positions, a SiLU-gated MLP in the first ``first_dense`` layers
    and routed plus shared SiLU-gated experts after them, last-token
    pooling.  The defaults are DeepSeek-V2-Lite's published config
    (huggingface.co/deepseek-ai/DeepSeek-V2-Lite, ``config.json``) under
    the port's names; ``max_len`` is the tokenizer's sequence length.
    ``vocab_size``, ``dim`` and ``max_len`` are named as ``DenseConfig``'s,
    so ``DenseModel`` hashes texts for either."""

    vocab_size: int = 102_400
    dim: int = 2048                  # hidden_size
    depth: int = 27                  # num_hidden_layers
    heads: int = 16
    kv_lora_rank: int = 512          # the latent KV width
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    dense_hidden: int = 10_944       # intermediate_size
    first_dense: int = 1             # first_k_dense_replace
    n_experts: int = 64              # n_routed_experts
    top_k: int = 6                   # num_experts_per_tok
    expert_hidden: int = 1408        # moe_intermediate_size
    n_shared: int = 2                # n_shared_experts
    rope_theta: float = 10_000.0
    rope_factor: float = 40.0        # YaRN's scaling factor
    rope_original_max: int = 4096    # original_max_position_embeddings
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.707    # 0: no YaRN factor on the scores
    rms_eps: float = 1e-6
    aux_alpha: float = 0.001         # the sequence-level balance loss's weight
    max_len: int = 256
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class TdrConfig:
    data: DataConfig = field(default_factory=DataConfig)
    bm25: BM25Config = field(default_factory=BM25Config)
    index: IndexConfig = field(default_factory=IndexConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    dense: DenseConfig = field(default_factory=DenseConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "TdrConfig":
        raw = json.loads(text)

        def build(klass, d):
            fields = {f.name: f for f in dataclasses.fields(klass)}
            kwargs = {}
            for k, v in d.items():
                if k not in fields:
                    continue
                t = fields[k].type
                if dataclasses.is_dataclass(fields[k].default_factory()) if fields[k].default_factory is not dataclasses.MISSING else False:  # pragma: no cover
                    v = build(type(fields[k].default_factory()), v)
                kwargs[k] = v
            return klass(**kwargs)

        return cls(
            data=build(DataConfig, raw.get("data", {})),
            bm25=build(BM25Config, raw.get("bm25", {})),
            index=build(IndexConfig, raw.get("index", {})),
            mesh=build(MeshConfig, raw.get("mesh", {})),
            retrieval=build(RetrievalConfig, raw.get("retrieval", {})),
            dense=build(DenseConfig, raw.get("dense", {})),
        )
