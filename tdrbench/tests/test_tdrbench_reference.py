"""The plain reference against the port at a small size on the CPU: the
text layer, BM25's statistics and scores, the hashing tokenizer, and the
encoder's forward, loss, gradient and AdamW step."""

from collections import Counter

import numpy as np
import pytest
import torch

from tdrbench.harness.synthetic import SyntheticSpec, synthetic_corpus
from tdrbench.reference import encoder as ref_enc
from tdrbench.reference.bm25 import BM25Reference
from tdrbench.reference.hashing import Hasher
from tdrbench.reference.text import (Analyzer, encode_corpora, encode_corpus,
                                     encode_queries)

EXTRA = {
    "en": ["The boxes, wishes and women's churches: 12 analyses!",
           "foo_bar baz-qux l'été «quoted» naïve Straße"],
    "de": ["Die Häuser und die Straßen, schönen Grüße_aus Berlin."],
    "fr": ["Les enfants continuellement mangeaient; l'été était chaud."],
    "es": ["Las canciones nacionales y los corazones rápidos."],
    "it": ["Le città italiane, continuamente visitate."],
    "ar": ["الْكِتَابُ أَحْمَد إلى المدرسة ـ قرأ"],
    "ko": ["학교에서 공부했습니다 그리고 ABC123 친구들과"],
}


@pytest.fixture(scope="module")
def corpus():
    return synthetic_corpus(SyntheticSpec(n_docs=2500, n_queries=300, seed=3,
                                          hard=True))


def by_lang(c, lang):
    return [t for t, l in zip(c.texts, c.langs) if l == lang]


@pytest.mark.parametrize("lang", sorted(EXTRA))
def test_text_matches_the_ports_pipeline(corpus, lang):
    from tdr_torch.text.fast import fast_tokenize_texts
    from tdr_torch.text.preprocess import Preprocessor

    texts = by_lang(corpus[0], lang)[:60] + EXTRA[lang]
    an = Analyzer(lang)
    mine = [an.tokens(t) for t in texts]
    assert mine == [Preprocessor("best")(t, lang) for t in texts]
    q = [t for t, l in zip(corpus[1].queries, corpus[1].langs) if l == lang]
    assert [an.tokens(t) for t in q] == fast_tokenize_texts(q, lang)


@pytest.mark.parametrize("lang", ["en", "de", "ko"])
def test_bulk_counts_equal_the_per_document_tokens(corpus, lang):
    texts = by_lang(corpus[0], lang) + EXTRA[lang]
    ix = encode_corpus(texts, lang, chars=5000)
    an = Analyzer(lang)
    name = {i: s for s, i in ix.unigram.items()}
    n = len(ix.unigram)
    for j, k in enumerate(ix.bigram.tolist()):
        name[n + j] = f"{name[k // n]}_{name[k % n]}"
    for d, text in enumerate(texts):
        want = Counter(an.tokens(text))
        sel = ix.doc == d
        got = {name[int(t)]: int(c) for t, c in zip(ix.term[sel], ix.tf[sel])}
        assert got == want and ix.doc_len[d] == sum(want.values())


def test_workers_count_as_one_process(corpus):
    texts = {lang: by_lang(corpus[0], lang) + EXTRA[lang]
             for lang in ("en", "de", "ko")}
    par = encode_corpora(texts, 2, chars=20000)
    for lang, t in texts.items():
        one = encode_corpus(t, lang)
        counts = []
        for ix in (one, par[lang]):
            name = {i: w for w, i in ix.unigram.items()}
            n = len(ix.unigram)
            for j, k in enumerate(ix.bigram.tolist()):
                name[n + j] = f"{name[k // n]}_{name[k % n]}"
            name = [name[i] for i in range(ix.n_terms)]
            counts.append(sorted(zip(ix.doc.tolist(),
                                     [name[i] for i in ix.term], ix.tf)))
            assert len(set(name)) == ix.n_terms
        assert counts[0] == counts[1]
        np.testing.assert_array_equal(one.doc_len, par[lang].doc_len)


@pytest.mark.parametrize("lang", ["en", "es", "ar"])
def test_bm25_scores_match_the_port(corpus, lang):
    """f32 heads and the scatter path: the port's top 10 of each query equal
    the reference's, scores within rtol 1e-5."""
    from tdr_torch.models.sparse import BM25Model
    from tdr_torch.text.fast import fast_tokenize_texts
    from tdr_torch.utils.config import IndexConfig

    docs = by_lang(corpus[0], lang)
    q = [t for t, l in zip(corpus[1].queries, corpus[1].langs)
         if l == lang][:40]
    an = Analyzer(lang)
    model = BM25Model.build([an.tokens(t) for t in docs],
                            [str(i) for i in range(len(docs))], lang=lang,
                            index_cfg=IndexConfig(head_dtype="float32",
                                                  head_budget_bytes=1 << 20),
                            device="cpu")
    vals, rows = model.topk_tokens(fast_tokenize_texts(q, lang), k=10)
    ix = encode_corpus(docs, lang)
    ref = BM25Reference(ix, 1.5, 0.75, False, "bm25", "cpu")
    s = ref.scores(encode_queries(q, ix)).numpy()
    at = np.take_along_axis(s, rows.astype(np.int64), 1)
    np.testing.assert_allclose(vals, at, rtol=1e-5, atol=1e-6)
    kth = np.sort(s, 1)[:, -10]
    assert (at >= kth[:, None] * (1 - 1e-5) - 1e-6).all()


def test_hashing_matches_the_port(corpus):
    from tdr_torch.text.hash_tokenizer import encode_batch, encode_batch_python

    texts = corpus[0].texts[:50] + corpus[1].queries[:50] + EXTRA["ko"]
    ids, mask = Hasher(50_000, 128).encode(texts)
    for fn in (encode_batch, encode_batch_python):
        p_ids, p_mask = fn(texts, 50_000, 128)
        np.testing.assert_array_equal(ids, p_ids)
        np.testing.assert_array_equal(mask, p_mask)


def small_cfg():
    return {"hidden_size": 32, "num_hidden_layers": 2,
            "num_attention_heads": 4, "intermediate_size": 128,
            "vocab_size": 500, "max_position_embeddings": 16,
            "layer_norm_eps": 1e-6}


def port_and_weights(seed=4):
    from tdr_torch.models.encoder import DualEncoder
    from tdr_torch.utils.config import DenseConfig

    from tdrbench.traffic.contrastive_train import make_weights

    m = small_cfg()
    cfg = DenseConfig(vocab_size=500, dim=32, depth=2, heads=4, mlp_ratio=4.0,
                      max_len=16, dtype="float32")
    p0 = make_weights(m, seed, "cpu")
    model = DualEncoder(cfg)
    model.load_state_dict(p0)
    return m, model, p0


def batch(n=6, L=16, seed=0):
    g = np.random.RandomState(seed)
    ids = g.randint(2, 500, (2 * n, L))
    lens = g.randint(3, L + 1, 2 * n)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    ids = ids * mask.astype(np.int64)
    return [torch.as_tensor(x) for x in (ids[:n], mask[:n], ids[n:], mask[n:])]


def test_encoder_forward_loss_and_gradient_match_the_port():
    from tdr_torch.train.contrastive import contrastive_loss

    m, model, p0 = port_and_weights()
    qi, qm, pi, pm = batch()
    with ref_enc.ieee_f32():
        want = ref_enc.encode(p0, qi, qm, m)
    got = model(qi, qm)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    loss, grads = ref_enc.loss_and_grad(p0, (qi, qm, pi, pm), m, 0.05, chunk=4)
    p_loss, _ = contrastive_loss(model(qi, qm), model(pi, pm), None, 0.05)
    p_loss.backward()
    assert loss == pytest.approx(float(p_loss.detach()), rel=1e-5)
    # f32 sums in another order: each leaf within 1e-4 of its largest entry
    # or of the median leaf's, whichever is larger (the key biases' gradient
    # is round-off under the softmax)
    med = torch.stack([g.abs().max() for g in grads.values()]).median()
    for k, p in model.named_parameters():
        scale = torch.maximum(grads[k].abs().max(), med)
        assert (p.grad - grads[k]).abs().max() <= 1e-4 * scale


def test_adamw_matches_torch():
    _, model, p0 = port_and_weights()
    g = {k: torch.randn_like(v) * 1e-3 for k, v in p0.items()}
    opt = torch.optim.AdamW(model.parameters(), lr=2e-5, weight_decay=0.01,
                            betas=(0.9, 0.999), eps=1e-8)
    mine = ref_enc.AdamW(p0, 2e-5, 0.01)
    p = p0
    for _ in range(3):
        for k, prm in model.named_parameters():
            prm.grad = g[k].clone()
        opt.step()
        p = mine.step(p, g)
    for k, prm in model.named_parameters():
        torch.testing.assert_close(prm.detach(), p[k], rtol=1e-6, atol=1e-9)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096)
    e8 = (ref_enc.fp8(x) - x).abs().max() / x.abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max() / x.abs().max()
    assert e8 > 4 * e16
