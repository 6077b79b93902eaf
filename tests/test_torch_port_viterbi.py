"""Kernel 6 and the device Viterbi of the PyTorch port
(zett_tpu_torch/ops/viterbi_dp.py, ops/device_viterbi.py) held against the
JAX package on the CPU: the plain DP against the Pallas kernel in interpret
mode and against the lax.scan DP, the plain version of the fused span-score
DP against JAX's viterbi_device, and every public function of
device_viterbi against its JAX counterpart on the same numpy inputs. All
comparisons are exact (both sides do the same f32 adds and int32 selects)
unless a tolerance is stated."""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zett_tpu.csrc import host_lib as jax_host_lib
from zett_tpu.ops import device_viterbi as J
from zett_tpu.ops.pallas_viterbi import viterbi_dp_pallas
from zett_tpu_torch.csrc import host_lib
from zett_tpu_torch.ops import _build
from zett_tpu_torch.ops import device_viterbi as T
from zett_tpu_torch.ops.viterbi_dp import NEG, viterbi_dp, viterbi_dp_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan_dp(S, I):
    """The lax.scan DP of zett_tpu/ops/device_viterbi.py:244-268."""
    B, L, K = S.shape
    dp0 = jnp.full((B, L + K), NEG, dtype=jnp.float32).at[:, 0].set(0.0)
    bk0 = jnp.zeros((B, L + K), jnp.int32)
    bi0 = jnp.full((B, L + K), -1, jnp.int32)

    def step(carry, j):
        dp, bk, bi = carry
        dj = jax.lax.dynamic_slice(dp, (0, j), (B, 1))
        cand = dj + S[:, j, :]
        window = jax.lax.dynamic_slice(dp, (0, j + 1), (B, K))
        better = cand > window
        dp = jax.lax.dynamic_update_slice(dp, jnp.where(better, cand, window), (0, j + 1))
        bkw = jax.lax.dynamic_slice(bk, (0, j + 1), (B, K))
        biw = jax.lax.dynamic_slice(bi, (0, j + 1), (B, K))
        bk = jax.lax.dynamic_update_slice(
            bk, jnp.where(better, jnp.arange(1, K + 1)[None], bkw), (0, j + 1))
        bi = jax.lax.dynamic_update_slice(bi, jnp.where(better, I[:, j, :], biw), (0, j + 1))
        return (dp, bk, bi), None

    (dp, bk, bi), _ = jax.lax.scan(step, (dp0, bk0, bi0), jnp.arange(L))
    return dp, bk, bi


def _dp_inputs(B, L, K, seed, ties=False):
    """Span scores with absent spans, single-byte spans always present, a few
    all-NEG rows; with ``ties`` the scores take four values only, so many
    candidates tie exactly."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-4, 0, size=(B, L, K)).astype(np.float32) if ties
            else (rng.normal(size=(B, L, K)) - 2).astype(np.float32))
    S = np.where(rng.random((B, L, K)) < 0.4, vals, NEG).astype(np.float32)
    S[:, :, 0] = vals[:, :, 0] - 3
    S[::7] = NEG  # rows with no span at all
    I = rng.integers(0, 100, size=(B, L, K)).astype(np.int32)
    return S, I


def _assert_dp_equal(got, want):
    for name, g, w in zip(("dp", "bk", "bi"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("B,L,K", [(64, 24, 8), (100, 16, 16), (37, 48, 16), (5, 7, 7)])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_plain_dp_matches_pallas_and_scan(B, L, K, ties):
    """Bit equality of dp, bk and bi against the Pallas kernel (interpret
    mode) and the lax.scan DP, including exact ties and all-NEG rows."""
    S, I = _dp_inputs(B, L, K, seed=B + L + K, ties=ties)
    got = viterbi_dp_plain(torch.from_numpy(S), torch.from_numpy(I))
    _assert_dp_equal(got, viterbi_dp_pallas(jnp.asarray(S), jnp.asarray(I), tile_b=128,
                                            interpret=True))
    _assert_dp_equal(got, _scan_dp(jnp.asarray(S), jnp.asarray(I)))


def test_viterbi_dp_wrapper_takes_plain_version_on_cpu():
    S, I = _dp_inputs(9, 12, 5, seed=3, ties=True)
    before = dict(_build.launch_counts)
    got = viterbi_dp(torch.from_numpy(S), torch.from_numpy(I))
    _assert_dp_equal(got, viterbi_dp_plain(torch.from_numpy(S), torch.from_numpy(I)))
    assert _build.launch_counts == before


@pytest.fixture(scope="module")
def vocab(corpus):
    """A Unigram vocab sampled from the corpus (raw bytes), as
    tests/test_device_viterbi.py builds it."""
    from zett_tpu.tokenization.bytemaps import CHARS_TO_BYTES
    from zett_tpu.tokenization.sampler import TokenizerSampler

    sampled = TokenizerSampler().sample_tokenizer({t: 1 for t in corpus if t.strip()}, 3000,
                                                  16, 1, 0.0)
    pieces, scores = [], []
    for p, s in sampled:
        try:
            raw = bytes(CHARS_TO_BYTES[c] for c in p)
        except KeyError:
            continue
        pieces.append(raw)
        scores.append(s)
    return pieces, scores


@pytest.fixture(scope="module")
def pretokens(corpus):
    from zett_tpu.tokenization.sampler import pretokenize_bytes

    out = []
    for t in corpus:
        if t.strip():
            out.extend(raw for raw, _ in pretokenize_bytes(t) if len(raw) <= 48)
    return out[:2000]


def _random_vocab(seed, n=2500, drop=(0xF5, 0xF6, 0xF7, 0xFE, 0xFF)):
    """Random byte pieces, every single byte but ``drop`` (so those bytes
    take the unk path), one empty piece (a special), and a duplicate."""
    rng = np.random.default_rng(seed)
    pieces = sorted({rng.bytes(int(rng.integers(2, 9))) for _ in range(n)})
    pieces += [bytes([b]) for b in range(256) if b not in drop] + [b"", pieces[3]]
    scores = (rng.normal(size=len(pieces)) * 2 - 8).tolist()
    return pieces, scores


@pytest.mark.parametrize("seed", [0, 1])
def test_build_vocab_table_matches_jax(seed):
    """Native and Python builds against JAX's: same table, salt and
    max_piece_len."""
    pieces, scores = _random_vocab(seed)
    want = J.build_vocab_table(pieces, scores)
    for use_native in (True, False):
        got = T.build_vocab_table(pieces, scores, use_native=use_native)
        np.testing.assert_array_equal(got.table, want.table)
        assert (got.salt, got.max_piece_len, got.M) == (want.salt, want.max_piece_len, want.M)


def _rows(seed, B=300, L=24):
    """Pretokens of random bytes (>= 0x80 and unk bytes included), empty
    ones and ones of exactly L bytes."""
    rng = np.random.default_rng(seed)
    pts = [rng.bytes(int(rng.integers(0, L + 1))) for _ in range(B)]
    pts[:4] = [b"", bytes([0xFF]) * L, rng.bytes(L), bytes(range(0x80, 0x80 + L))]
    return pts


@pytest.mark.parametrize("K", [8, 16])
def test_span_scores_and_viterbi_match_jax(K):
    pieces, scores = _random_vocab(5)
    table = T.build_vocab_table(pieces, scores)
    jtab = J.build_vocab_table(pieces, scores)
    unk = min(scores) - 10.0
    pts = _rows(K)
    rows, lens = T.pack_pretokens(pts, 24)
    jrows, jlens = J.pack_pretokens(pts, 24)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(lens, jlens)
    r, ln, tab = torch.from_numpy(rows), torch.from_numpy(lens), torch.from_numpy(table.table)
    jr, jl, jt = jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(jtab.table)

    S, I = T.compute_span_scores(r, ln, tab, table.salt, unk, K)
    jS, jI = J.compute_span_scores(jr, jl, jt, jtab.salt, unk, K)
    np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
    np.testing.assert_array_equal(I.numpy(), np.asarray(jI))
    assert (I.numpy() == -2).any() and (I.numpy() >= 0).any()  # unk and real pieces

    best, bk, bi = T.viterbi_device(r, ln, tab, table.salt, unk, K=K)
    jbest, jbk, jbi = J.viterbi_device(jr, jl, jt, jtab.salt, unk, K=K)
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(bk.numpy(), np.asarray(jbk))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    only_best = T.viterbi_device(r, ln, tab, table.salt, unk, K=K, with_backtrack=False)
    assert only_best[1] is None and torch.equal(only_best[0], best)

    ids_rev = T.backtrack_device(bk, bi, ln)
    np.testing.assert_array_equal(ids_rev.numpy(), np.asarray(J.backtrack_device(jbk, jbi, jl)))
    segs = T.unpack_backtrack(ids_rev.numpy())
    assert segs == J.unpack_backtrack(np.asarray(J.backtrack_device(jbk, jbi, jl)))
    assert segs == T.backtrack_ids(bk.numpy(), bi.numpy(), lens)
    assert segs == J.backtrack_ids(np.asarray(jbk), np.asarray(jbi), jlens)

    w = np.random.default_rng(K).integers(1, 1000, size=len(pts))
    counts = T.count_token_usage(bk, bi, ln, len(pieces), weights=torch.from_numpy(w))
    jcounts = J.count_token_usage(jbk, jbi, jl, len(pieces), weights=jnp.asarray(w, jnp.int32))
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(T.count_token_usage(bk, bi, ln, len(pieces)).numpy(),
                                  np.asarray(J.count_token_usage(jbk, jbi, jl, len(pieces))))


def _tie_vocab(seed, drop=(0xF5, 0xF6, 0xF7, 0xFE, 0xFF)):
    """_random_vocab with scores of four values only, so segmentations tie
    exactly."""
    pieces, _ = _random_vocab(seed, n=1500, drop=drop)
    rng = np.random.default_rng(seed + 100)
    return pieces, rng.integers(-12, -8, size=len(pieces)).astype(np.float32).tolist()


@pytest.mark.parametrize("L,K", [(8, 8), (20, 16), (48, 16), (64, 16), (64, 64)])
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_fused_spans_dp_plain_matches_jax(L, K, ties):
    """The fused kernel's plain version (kernel 6's DP over the span scores)
    against JAX's viterbi_device, exact: best scores and backpointers, with
    empty rows, unk bytes, full rows and exact ties. Past each row's length
    the outputs keep NEG, 0 and -1 and no span reaches there, which is what
    lets the kernel skip spans past the pretoken's end and stop its scan at
    the length."""
    pieces, scores = (_tie_vocab if ties else _random_vocab)(L + K)
    table = T.build_vocab_table(pieces, scores)
    jtab = J.build_vocab_table(pieces, scores)
    unk = min(scores) - 10.0
    pts = _rows(L + K, B=200, L=L)
    rows, lens = T.pack_pretokens(pts, L)
    r, ln, tab = torch.from_numpy(rows), torch.from_numpy(lens), torch.from_numpy(table.table)
    before = dict(_build.launch_counts)
    dp, bk, bi = T.viterbi_spans_dp(r, ln, tab, table.salt, unk, K)
    assert _build.launch_counts == before  # CPU tensors: the plain version, no launch
    want = T.viterbi_spans_dp_plain(r, ln, tab, table.salt, unk, K)
    _assert_dp_equal((dp, bk, bi), [w.numpy() for w in want])
    assert dp.shape == (len(pts), L + K)

    jbest, jbk, jbi = J.viterbi_device(jnp.asarray(rows), jnp.asarray(lens),
                                       jnp.asarray(jtab.table), jtab.salt, unk, K=K)
    best = dp.gather(1, ln.long()[:, None])[:, 0]
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(bk[:, :L + 1].numpy(), np.asarray(jbk))
    np.testing.assert_array_equal(bi[:, :L + 1].numpy(), np.asarray(jbi))
    assert (lens == 0).any() and (lens == L).any()
    assert (bi.numpy() == -2).any() and (bi.numpy() >= 0).any()  # unk bytes and pieces
    past = torch.arange(L + K)[None, :] > ln[:, None]
    assert bool((dp[past] == NEG).all() and (bk[past] == 0).all() and (bi[past] == -1).all())
    # what lets the kernel end a bucket's search at a hit or an empty entry:
    # entries fill in order, keys are unique
    ent = table.table.reshape(-1, 4, 4)
    used = ent[:, :, 0] != 0
    assert not (~used[:, :-1] & used[:, 1:]).any()
    keys = ent[used][:, :2]
    assert len(np.unique(keys, axis=0)) == len(keys)


def _native_segs(pieces, scores, pretokens):
    native = jax_host_lib.NativeUnigram(pieces, scores, unk_id=-1)
    return [[int(x) for x in s] for s in native.encode_pretokens(pretokens)]


def test_retokenizer_matches_jax_and_native(vocab, pretokens):
    """encode, best_scores and token_counts on the corpus against JAX's
    DeviceRetokenizer (exact) and the native encoder (segmentations exact,
    scores at rtol 1e-4 as tests/test_device_viterbi.py:68: f32 sums
    against f64)."""
    pieces, scores = vocab
    dev = T.DeviceRetokenizer(pieces, scores, max_pretoken_len=48, device="cpu")
    jdev = J.DeviceRetokenizer(pieces, scores, max_pretoken_len=48)
    segs = dev.encode(pretokens)
    assert segs == jdev.encode(pretokens)
    assert segs == _native_segs(pieces, scores, pretokens)
    port_native = host_lib.NativeUnigram(pieces, scores, unk_id=-1)
    assert [s.tolist() for s in port_native.encode_pretokens(pretokens)] == segs
    flat, n_ids = port_native.encode_flat(pretokens)
    assert flat.tolist() == [t for row in segs for t in row]
    assert n_ids.tolist() == [len(row) for row in segs]
    sc = dev.best_scores(pretokens[:500])
    np.testing.assert_array_equal(sc, jdev.best_scores(pretokens[:500]))
    native = host_lib.NativeUnigram(pieces, scores, unk_id=-1)
    np.testing.assert_allclose(sc, native.score_pretokens(pretokens[:500]), rtol=1e-4, atol=1e-4)
    counts = dev.token_counts(pretokens[:400])
    np.testing.assert_array_equal(counts, jdev.token_counts(pretokens[:400]))
    expected = Counter(t for row in segs[:400] for t in row if t >= 0)
    assert counts.sum() == sum(expected.values())
    assert all(counts[pid] == c for pid, c in expected.items())


def test_retokenizer_memo_and_width_buckets(vocab, pretokens, monkeypatch):
    """A second call segments nothing again; pretokens longer than
    max_pretoken_len are truncated as in JAX; widths 8 and 12 use K = 8
    and 12."""
    pieces, scores = vocab
    long_ones = [p * 6 for p in pretokens[:20]]
    pts = pretokens[:300] + long_ones
    dev = T.DeviceRetokenizer(pieces, scores, max_pretoken_len=20, device="cpu")
    jdev = J.DeviceRetokenizer(pieces, scores, max_pretoken_len=20)
    assert dev._widths == jdev._widths == [8, 12, 16, 20]
    seen_K = []
    orig = T.viterbi_device

    def spy(rows, lens, table, salt, unk, K=16, with_backtrack=True):
        seen_K.append((rows.shape[1], K))
        return orig(rows, lens, table, salt, unk, K=K, with_backtrack=with_backtrack)

    monkeypatch.setattr(T, "viterbi_device", spy)
    assert dev.encode(pts) == jdev.encode(pts)
    lengths = {len(p[:20]) for p in pts}
    groups = [w for lo, w in zip([-1, 8, 12, 16], dev._widths) if any(lo < n <= w for n in lengths)]
    assert len(groups) == 4
    assert sorted(seen_K) == [(w, min(dev.K, w)) for w in groups]
    seen_K.clear()
    assert dev.encode(pts[::-1]) == jdev.encode(pts[::-1])
    assert seen_K == []  # memoized
    fresh = T.DeviceRetokenizer(pieces, scores, max_pretoken_len=20, memoize=False,
                                device="cpu")
    assert fresh.encode(pts) == jdev.encode(pts)


def test_count_tokens_device_matches_jax(vocab, pretokens):
    pieces, scores = vocab
    weighted = Counter(p[:16] for p in pretokens[:700])
    got = T.count_tokens_device(pieces, scores, weighted, max_pretoken_len=16, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, J.count_tokens_device(pieces, scores, weighted,
                                                             max_pretoken_len=16))


@pytest.mark.parametrize("overlong", ["host", "truncate"])
def test_count_tokens_device_overlong(vocab, overlong):
    """The overlong tail segmented by the native encoder ("host") or
    truncated, as in JAX (tests/test_device_viterbi.py:149-173)."""
    pieces, scores = vocab
    weighted = {b" the" * 20: 5, b" the": 2, b" of": 1}
    got = T.count_tokens_device(pieces, scores, weighted, max_pretoken_len=16,
                                overlong=overlong, device="cpu")
    want = J.count_tokens_device(pieces, scores, weighted, max_pretoken_len=16,
                                 overlong=overlong)
    np.testing.assert_array_equal(got, want)
    native = np.zeros(len(pieces), dtype=np.int64)
    for (p, w), seg in zip(weighted.items(), _native_segs(pieces, scores, list(weighted))):
        for t in seg:
            native[t] += w
    assert np.array_equal(got, native) == (overlong == "host")


def test_count_tokens_device_int64_weights(vocab):
    """A weight over 2^31: counts stay exact in int64 (as
    tests/test_device_viterbi.py:176-194)."""
    pieces, scores = vocab
    weighted = {b" the": (1 << 31) + 12345, b" and": 3, b" of": 2}
    got = T.count_tokens_device(pieces, scores, weighted, device="cpu")
    np.testing.assert_array_equal(got, J.count_tokens_device(pieces, scores, weighted))
    expected = np.zeros(len(pieces), dtype=np.int64)
    for (p, w), seg in zip(weighted.items(), _native_segs(pieces, scores, list(weighted))):
        for t in seg:
            expected[t] += w
    np.testing.assert_array_equal(got, expected)
    assert got.sum() > (1 << 31)


def test_count_tokens_device_rejects_unknown_overlong(vocab):
    pieces, scores = vocab
    with pytest.raises(ValueError, match="overlong"):
        T.count_tokens_device(pieces, scores, {b" a": 1}, overlong="clip", device="cpu")


def _neox_pieces():
    from zett_tpu_torch.tokenization import Tokenizer
    from zett_tpu_torch.tokenization.bytemaps import CHARS_TO_BYTES

    tok = Tokenizer.from_file(os.path.join(REPO, "artifacts", "tokenizers", "gpt_neox0001",
                                           "tokenizer.json"))
    special = set(tok.all_special_tokens)
    scores = tok.model.get_scores()
    pieces = []
    for i in range(len(scores)):
        t = tok.id_to_token(i) or ""
        pieces.append(b"" if t in special or not t else bytes(CHARS_TO_BYTES[c] for c in t))
    return pieces, scores


def test_f32_dp_and_f64_native_break_exact_ties_apart():
    """A fault of the reference (ROADMAP §C): where two segmentations are
    permutations of the same pieces, their scores tie exactly, and the f32
    DP (JAX's device path and the port) and the f64 native encoder may pick
    different ones by rounding. The port follows JAX's DP; the piece counts
    agree, since both segmentations hold the same pieces."""
    pieces, scores = _neox_pieces()
    pts = [b"---------|-----pE", b" ('-------FILLMatchSequence"]
    port = T.DeviceRetokenizer(pieces, scores, max_pretoken_len=32, device="cpu").encode(pts)
    jax_segs = J.DeviceRetokenizer(pieces, scores, max_pretoken_len=32).encode(pts)
    native = _native_segs(pieces, scores, pts)
    assert port == jax_segs
    for p, n in zip(port, native):
        assert p != n and sorted(p) == sorted(n)
    w = {p: 3 for p in pts}
    np.testing.assert_array_equal(
        T.count_tokens_device(pieces, scores, w, max_pretoken_len=32, device="cpu"),
        J.count_tokens_device(pieces, scores, w, max_pretoken_len=32))
