"""K1's one-launch design and the f32 precision pin, on CPU.

``tdr_torch/csrc/tail_compact.cu`` does K1's whole job in one launch: term
compaction in one warp (a stable rank from ``__ballot_sync`` + ``__popc``
over 32-term chunks), the offsets from a ``__shfl_up_sync`` scan, the two
overflow conditions, and each lane written once from the last compacted
term that covers it, by CTAs of 512 lanes that skip the term work where no
lane can be live.  The kernel runs only on the card (``chip_smoke.py``
holds it against the plain version there, bit for bit); here a numpy model
of that algorithm, step for step, is held bit for bit against ``tdr``'s
``tail_compact_pallas`` (interpret mode) and against the port's plain
version, on cases that reach each of its branches.  Inputs come from numpy
seeds.

``ieee_f32`` pins full IEEE f32 matmuls for its body and restores the
caller's setting, in both of torch's APIs.
"""

import numpy as np
import pytest

from tests.torch_threads import torch

import jax.numpy as jnp  # noqa: E402

from tdr.index import build_index  # noqa: E402
from tdr.ops.pallas_tail import tail_compact_pallas  # noqa: E402
from tdr_torch.ops import cuda_build, precision  # noqa: E402
from tdr_torch.ops import tail_compact as ttail  # noqa: E402
from tdr_torch.ops.precision import ieee_f32  # noqa: E402
from test_torch_kernels import TAIL_CFG, _world, carry  # noqa: E402

LANES_PER_CTA = 512        # csrc/tail_compact.cu: 128 threads x 4 lanes


def _popc(x):
    return bin(x).count("1")


def kernel_model(index, qids, qw, budget, max_tail_terms=16):
    """The CUDA kernel's algorithm in numpy, warp step for warp step:
    (docs (Q, W) int32, vals (Q, W) f32, overflow (Q,) bool)."""
    head_slot = index.head_slot.numpy()
    df = index.stats.df.numpy()
    indptr = index.indptr.numpy()
    pdoc = index.postings_doc.numpy()
    pw = index.postings_w.numpy()
    Q, T = qids.shape
    MT = min(max_tail_terms, T)
    V, nnz = index.vocab_size, pdoc.shape[0]
    W = ttail.row_width(budget, index.tail_pmax)
    pmax = max(index.tail_pmax, 1)
    docs = np.empty((Q, W), np.int32)
    vals = np.empty((Q, W), np.float32)
    overflow = np.zeros(Q, bool)
    j = np.arange(W)
    for q in range(Q):
        # one warp: ranks by ballot + popc over 32-term chunks
        s_start, s_len, s_w = [0] * 32, [0] * 32, [np.float32(0)] * 32
        n_tail = 0
        for base in range(0, T, 32):
            ballot, lane_terms = 0, {}
            for lane in range(32):
                t = base + lane
                if t >= T:
                    continue
                tid = min(max(int(qids[q, t]), 0), V - 1)
                w = np.float32(qw[q, t])
                if head_slot[tid] < 0 and w > 0:
                    ballot |= 1 << lane
                    lane_terms[lane] = (int(indptr[tid]), int(df[tid]), w)
            for lane, term in lane_terms.items():
                rank = n_tail + _popc(ballot & ((1 << lane) - 1))
                if rank < MT:
                    s_start[rank], s_len[rank], s_w[rank] = term
            n_tail += _popc(ballot)
        kept = min(n_tail, MT)
        # Hillis-Steele inclusive scan, as __shfl_up_sync does it
        lens = [s_len[lane] if lane < kept else 0 for lane in range(32)]
        cum, d = list(lens), 1
        while d < 32:
            cum = [cum[lane] + (cum[lane - d] if lane >= d else 0)
                   for lane in range(32)]
            d *= 2
        offs = [min(cum[t] - lens[t], budget) for t in range(kept)]
        clen = [min(lens[t], pmax) for t in range(kept)]
        overflow[q] = n_tail > MT or cum[31] > budget
        # lanes: CTAs from budget + pmax on write dead lanes only; elsewhere
        # each lane takes the last kept term that covers it
        worked = (j // LANES_PER_CTA) * LANES_PER_CTA < budget + pmax
        term = np.full(W, -1)
        for t in range(kept):
            term[worked & (j >= offs[t]) & (j < offs[t] + clen[t])] = t
        docs[q], vals[q] = index.n_docs_pad, np.float32(-1.0)
        for t in range(kept):
            lane = np.nonzero(term == t)[0]
            src = np.clip(s_start[t] + lane - offs[t], 0, nnz - 1)
            docs[q, lane] = pdoc[src]
            vals[q, lane] = pw[src] * s_w[t]          # f32 x f32, rounded
    return docs, vals, overflow


def _terms(j):
    head_slot = np.asarray(j.head_slot)
    df = np.asarray(j.stats.df)
    return (np.where((head_slot < 0) & (df > 0))[0],
            np.where(head_slot >= 0)[0])


def _case(name, j, rng):
    """(qids, qw, budget) of one case."""
    tail, head = _terms(j)
    pick = lambda pool, n: rng.choice(pool, n, replace=False)  # noqa: E731
    heads = lambda n: rng.choice(head, n)          # noqa: E731 (16 slots)
    weights = lambda n: rng.choice([0.5, 1.0, 2.0, 3.0], n).astype(np.float32)  # noqa: E731
    P = j.tail_pmax
    if name == "prf_T69":
        # T + E = 69 terms, as PRF expands them: row 0 holds tail terms at
        # both edges of every 32-term chunk between head terms; rows 1-2 a
        # random mix with zero weights; row 3 over MT; row 4 no tail term
        Q, T = 5, 69
        qids = np.stack([heads(T) for _ in range(Q)]).astype(np.int32)
        qw = weights(Q * T).reshape(Q, T)
        edges = [0, 31, 32, 63, 64, 68]
        qids[0, edges] = pick(tail, len(edges))
        for q in (1, 2):
            qids[q] = np.where(rng.rand(T) < 0.5, pick(tail, T), heads(T))
            qw[q] *= rng.rand(T) < 0.2
        qids[3, 10:40] = pick(tail, 30)
        return qids, qw, 8 * P
    if name == "short_T8":
        qids = np.stack([pick(tail, 8) for _ in range(4)]).astype(np.int32)
        return qids, weights(32).reshape(4, 8), 4 * P
    if name == "single_Q1":
        qids = pick(tail, 12)[None].astype(np.int32)
        return qids, weights(12)[None], 4 * P
    if name == "no_tail":
        qids = np.stack([heads(20) for _ in range(3)]).astype(np.int32)
        qw = weights(60).reshape(3, 20)
        qids[2] = pick(tail, 20)
        qw[2] = 0.0                                    # tail terms, no weight
        return qids, qw, 4 * P
    if name == "out_of_range":
        qids = np.stack([pick(tail, 16) for _ in range(4)]).astype(np.int32)
        qids[0, [1, 5]] = [-7, j.vocab_size + 3]
        qids[1, :4] = [j.vocab_size, 2 ** 31 - 1, -1, -(2 ** 31)]
        qids[2, 0] = j.vocab_size - 1
        return qids, weights(64).reshape(4, 16), 4 * P
    if name == "zero_weights":
        qids = np.stack([pick(tail, 24) for _ in range(4)]).astype(np.int32)
        qw = weights(96).reshape(4, 24)
        qw[:, ::3] = 0.0
        qw[1, 1::4] = -1.0
        qw[2, 5] = -0.0
        qw[3, 7] = np.nan
        return qids, qw, 4 * P
    if name == "overflow_terms":
        qids = np.stack([pick(tail, 30) for _ in range(3)]).astype(np.int32)
        qw = weights(90).reshape(3, 30)
        qw[1, 17:] = 0.0                               # exactly 17 tail terms
        qw[2, 16:] = 0.0                               # exactly 16: no overflow
        return qids, qw, 16 * P
    assert name == "overflow_budget"
    # long segments over a small budget: clamped offsets overlap, the last
    # covering term decides the lanes
    long_tail = tail[np.argsort(-np.asarray(j.stats.df)[tail])][:40]
    qids = np.stack([pick(long_tail, 10) for _ in range(4)]).astype(np.int32)
    return qids, weights(40).reshape(4, 10), max(P // 2, 2)


CASES = ["prf_T69", "short_T8", "single_Q1", "no_tail", "out_of_range",
         "zero_weights", "overflow_terms", "overflow_budget"]
_INDEX = {}


def _index():
    if not _INDEX:
        vocab, coo, _, _ = _world(11, n_docs=600, vocab_n=700)
        j = build_index(*coo, vocab.size, index_cfg=TAIL_CFG, head_size=16)
        _INDEX["j"], _INDEX["t"] = j, carry(j)
    return _INDEX["j"], _INDEX["t"]


def _reference(which, j, t, qids, qw, budget):
    if which == "pallas":
        out = tail_compact_pallas(j, jnp.asarray(qids), jnp.asarray(qw),
                                  budget, interpret=True)
        return tuple(np.asarray(x) for x in out)
    before = dict(cuda_build.launches)
    out = ttail.tail_compact(t, torch.from_numpy(qids), torch.from_numpy(qw),
                             budget)
    assert cuda_build.launches == before        # CPU tensors: plain version
    return tuple(x.numpy() for x in out)


@pytest.mark.parametrize("which", ["pallas", "plain"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_model_bit_exact(case, which):
    j, t = _index()
    qids, qw, budget = _case(case, j, np.random.RandomState(CASES.index(case)))
    md, mv, mo = kernel_model(t, qids, qw, budget)
    rd, rv, ro = _reference(which, j, t, qids, qw, budget)
    np.testing.assert_array_equal(mo, ro)
    np.testing.assert_array_equal(md, rd)
    np.testing.assert_array_equal(mv.view(np.int32), rv.view(np.int32))
    # each case reaches the branch it is named for
    live = (mv >= 0).sum(axis=1)
    if case == "no_tail":
        assert live.max() == 0 and not mo.any()
    elif case == "overflow_terms":
        assert mo.tolist() == [True, True, False]
    elif case == "overflow_budget":
        assert mo.all() and (live <= budget + t.tail_pmax).all()
    elif case == "prf_T69":
        assert mo[3] and not mo[0] and live[0] > 0 and live[4] == 0
    else:
        assert live.min() > 0 or case in ("out_of_range", "zero_weights")


# -- ieee_f32 -------------------------------------------------------------


@pytest.fixture
def caller_setting():
    state = precision._saved()
    yield
    precision._restore(state)


def _new_api(name="cuda"):
    knob = getattr(getattr(torch.backends, name, None), "matmul", None)
    try:
        return knob.fp32_precision
    except (AttributeError, RuntimeError):
        return None


def _pinned():
    return (torch.get_float32_matmul_precision() == "highest"
            and _new_api() in (None, "ieee"))


@pytest.mark.parametrize("setting", ["highest", "high", "medium"])
def test_ieee_f32_pins_and_restores(caller_setting, setting):
    torch.set_float32_matmul_precision(setting)
    before = (torch.get_float32_matmul_precision(), _new_api(),
              _new_api("mkldnn"))
    with ieee_f32():
        assert _pinned()
    assert (torch.get_float32_matmul_precision(), _new_api(),
            _new_api("mkldnn")) == before
    assert torch.get_float32_matmul_precision() == setting


@pytest.mark.parametrize("tf32", [True, False])
def test_ieee_f32_restores_the_legacy_flag(caller_setting, tf32):
    torch.backends.cuda.matmul.allow_tf32 = tf32
    with ieee_f32():
        assert _pinned()
    assert torch.backends.cuda.matmul.allow_tf32 is tf32


def test_ieee_f32_restores_the_new_api(caller_setting):
    if _new_api() is None:
        pytest.skip("this torch has no fp32_precision knob")
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.backends.mkldnn.matmul.fp32_precision = "none"
    with ieee_f32():
        assert _pinned()
    assert _new_api() == "tf32" and _new_api("mkldnn") == "none"


def test_ieee_f32_nests_and_survives_an_exception(caller_setting):
    torch.set_float32_matmul_precision("high")
    with pytest.raises(KeyError):
        with ieee_f32():
            with ieee_f32():
                assert _pinned()
            assert _pinned()
            raise KeyError("body failed")
    assert torch.get_float32_matmul_precision() == "high"


def test_ieee_f32_decorates(caller_setting):
    torch.set_float32_matmul_precision("high")
    seen = []
    ieee_f32()(lambda: seen.append(_pinned()))()
    ieee_f32()(lambda: seen.append(_pinned()))()
    assert seen == [True, True]
    assert torch.get_float32_matmul_precision() == "high"


def test_ieee_f32_one_thread_at_a_time(caller_setting):
    import threading

    torch.set_float32_matmul_precision("high")
    a_in, a_go, b_in = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with ieee_f32():
            a_in.set()
            a_go.wait(10)
            seen["a"] = _pinned()

    def b():
        a_in.wait(10)
        with ieee_f32():
            b_in.set()
            seen["b"] = _pinned()

    ta, tb = threading.Thread(target=a), threading.Thread(target=b)
    ta.start()
    tb.start()
    assert a_in.wait(10)
    # B waits for A's pin to end: its own save would read A's pinned state
    assert not b_in.wait(0.2)
    a_go.set()
    ta.join(10)
    tb.join(10)
    assert seen == {"a": True, "b": True}
    assert torch.get_float32_matmul_precision() == "high"
