"""The port's MaxSim rescore (`ops/maxsim.py`) on CPU tensors — the plain
version the wrapper takes for them — against the JAX package's fused
kernel (interpret mode) and its reference twin, on the same numpy boards,
for f32, bf16, int8 and int4 token tiles.

Tolerance: rtol 1e-5, atol 1e-6 on every rung. Both sides round their
operands to bf16 and accumulate in f32; bf16 x bf16 products are exact in
f32, so only the order of the f32 sums differs. Candidate order agrees
wherever scores are separated by more than 1e-2, and candidates on the
all-zero padding row score at most -1e38 on both sides."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops.pallas_maxsim import (
    maxsim_reference as ref_reference, maxsim_rescore as ref_rescore)
from elasticsearch_tpu.quant import tokens as ref_tokens
from elasticsearch_tpu_torch.ops import dispatch, maxsim
from elasticsearch_tpu_torch.quant import tokens as port_tokens

RTOL, ATOL = 1e-5, 1e-6
N_PAD = 32


def _board(rng, encoding, n=24, cap=8, dims=32, nq=8, wc=16, tq=8):
    """Ragged docs of 1..cap tokens packed by the reference's token codec
    into a [N_PAD, cap, W] tile (rows n.. are padding), random candidate
    ids, and 1..tq prepped query tokens per query (zero rows after)."""
    docs = [rng.standard_normal((int(rng.integers(1, cap + 1)), dims))
            .astype(np.float32) for _ in range(n)]
    w = ref_tokens.packed_width(encoding, dims)
    toks = None
    scales = np.zeros((N_PAD, cap), dtype=np.float32)
    for i, d in enumerate(docs):
        data, sc = ref_tokens.encode_tokens(
            ref_tokens.prep_tokens(d, "cosine"), encoding, dims)
        if toks is None:
            toks = np.zeros((N_PAD, cap, w), dtype=data.dtype)
        toks[i, :len(d)] = data
        scales[i, :len(d)] = sc
    ids = rng.integers(0, n, size=(nq, wc)).astype(np.int32)
    q = np.zeros((nq, tq, ref_tokens.pad_dim(dims)), dtype=np.float32)
    for qi in range(nq):
        nt = int(rng.integers(1, tq + 1))
        q[qi, :nt, :dims] = ref_tokens.prep_tokens(
            rng.standard_normal((nt, dims)).astype(np.float32), "cosine")
    return ids, q, toks, scales


def _port_tile(toks: np.ndarray) -> torch.Tensor:
    """The same tile as the port holds it: bf16 through its bit pattern."""
    if toks.dtype.itemsize == 2:
        return torch.from_numpy(toks.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(toks)


def _port_board(ids, q, toks, scales):
    return maxsim.maxsim_rescore(torch.from_numpy(ids), torch.from_numpy(q),
                                 _port_tile(toks),
                                 torch.from_numpy(scales)).numpy()


@pytest.mark.parametrize("encoding", ["f32", "bf16", "int8", "int4"])
def test_board_matches_reference_kernel_and_twin(encoding):
    rng = np.random.default_rng(4)
    ids, q, toks, scales = _board(rng, encoding)
    got = _port_board(ids, q, toks, scales)
    kernel = np.asarray(ref_rescore(ids, q, toks, scales))
    twin = np.asarray(ref_reference(ids, q, toks, scales))
    assert got.shape == (8, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, twin, rtol=RTOL, atol=ATOL)
    for qi in range(got.shape[0]):
        go, ro = np.argsort(-got[qi], kind="stable"), \
            np.argsort(-kernel[qi], kind="stable")
        rv = kernel[qi][ro]
        sep = np.abs(np.diff(rv)) > 1e-2
        stable = np.concatenate([[True], sep]) & np.concatenate([sep, [True]])
        assert np.array_equal(go[stable], ro[stable])


@pytest.mark.parametrize("encoding", ["f32", "bf16", "int8", "int4"])
def test_padding_row_scores_below_neg_sentinel(encoding):
    rng = np.random.default_rng(5)
    ids, q, toks, scales = _board(rng, encoding)
    ids[:, -1] = N_PAD - 1                   # the all-zero padding row
    ids[0, :] = N_PAD - 1
    got = _port_board(ids, q, toks, scales)
    kernel = np.asarray(ref_rescore(ids, q, toks, scales))
    assert np.all(got[:, -1] <= -1e38) and np.all(got[0] <= -1e38)
    assert np.all(kernel[:, -1] <= -1e38)
    assert np.isfinite(got[1:, :-1]).all()


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(6)
    ids, q, toks, scales = _board(rng, "int8")
    before = dispatch.launches()
    got = _port_board(ids, q, toks, scales)
    want = maxsim.maxsim_reference(
        torch.from_numpy(ids), torch.from_numpy(q), torch.from_numpy(toks),
        torch.from_numpy(scales)).numpy()
    assert np.array_equal(got, want)
    assert dispatch.launches() == before


@pytest.mark.parametrize("encoding", ["f32", "bf16", "int8", "int4"])
def test_token_codec_is_byte_identical(encoding):
    rng = np.random.default_rng(7)
    toks = rng.standard_normal((37, 48)).astype(np.float32)
    for metric in ("cosine", "dot_product"):
        ref_p = ref_tokens.prep_tokens(toks, metric)
        port_p = port_tokens.prep_tokens(toks, metric)
        assert np.array_equal(ref_p, port_p)
        rd, rs = ref_tokens.encode_tokens(ref_p, encoding, 48)
        pd, ps = port_tokens.encode_tokens(port_p, encoding, 48)
        assert rd.shape == pd.shape == (37, port_tokens.packed_width(
            encoding, 48))
        assert rd.tobytes() == pd.tobytes() and rs.tobytes() == ps.tobytes()
        assert np.array_equal(ref_tokens.decode_tokens(rd, rs, encoding, 48),
                              port_tokens.decode_tokens(pd, ps, encoding, 48))
        assert ref_tokens.pool_doc(ref_p, metric).tobytes() \
            == port_tokens.pool_doc(port_p, metric).tobytes()
        assert ref_tokens.bytes_per_doc(encoding, 48, 70.5) \
            == port_tokens.bytes_per_doc(encoding, 48, 70.5)
